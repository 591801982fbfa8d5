"""The paper's streaming k-means workload (§III.2) in PyTorch, plus the
Mini-App synthetic data generator [11].  The autoencoder and the
isolation forest of ``repro.ml`` are not ported yet."""
from repro_torch.ml.datagen import MiniAppGenerator, message_nbytes
from repro_torch.ml.kmeans import KMeans

__all__ = ["KMeans", "MiniAppGenerator", "message_nbytes"]
