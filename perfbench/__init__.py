"""The benchmark of videopose3d_torch on an NVIDIA H100 (see README.md)."""
