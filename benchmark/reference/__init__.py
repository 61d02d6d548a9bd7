"""The plain reference the benchmark holds the port to: a frozen copy of
the port's eager modules (model, losses, GT crops, geometry, the plain
EMD and Chamfer), without its kernels, remat or data-parallel ranks,
plus plain Adam and EMA (``train``) and KITTI sample assembly and
prediction formatting (``kitti``). It imports nothing of the port, of
JAX or of the JAX package, and takes nothing the port made."""
