"""Hand-written Hopper kernels with their plain PyTorch versions
(``kmeans``, ``flash_attention``, ``ssd``), their oracles (``ref``), int8
quantization (``quant``), the nvcc/ctypes builder (``build``) and the
device-dispatching wrappers (``ops``)."""
