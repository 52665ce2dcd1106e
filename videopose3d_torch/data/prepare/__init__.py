"""Offline dataset preparation: numpy command-line tools, the counterparts of
``videopose3d_tpu/data/prepare/`` (the reference's ``data/`` scripts) with the
same flags.

Each module runs as ``python -m videopose3d_torch.data.prepare.<name>`` and writes
the ``data_3d_<dataset>.npz`` / ``data_2d_<dataset>_<kind>.npz`` archives both
packages read, bit for bit the JAX package's tools' archives on the same inputs.
"""
