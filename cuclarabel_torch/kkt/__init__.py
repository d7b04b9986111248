"""Dense KKT backend and its hand-written LDL^T kernels."""
