"""Hand-written Hopper kernels with their plain PyTorch versions
(``kmeans``), the k-means oracles (``ref``), int8 quantization
(``quant``) and the device-dispatching wrappers (``ops``)."""
