"""Plain PyTorch / NumPy reference of the benchmarked model: no import of the
program (``videopose3d_torch``) and nothing the program made."""
