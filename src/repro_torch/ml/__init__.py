"""The paper's three outlier-detection workloads (§III.2) in PyTorch —
streaming k-means, the isolation forest and the auto-encoder — plus the
Mini-App synthetic data generator [11]."""
from repro_torch.ml.autoencoder import AutoEncoder
from repro_torch.ml.datagen import MiniAppGenerator, message_nbytes
from repro_torch.ml.isoforest import IsolationForest
from repro_torch.ml.kmeans import KMeans

__all__ = ["AutoEncoder", "IsolationForest", "KMeans", "MiniAppGenerator",
           "message_nbytes"]
