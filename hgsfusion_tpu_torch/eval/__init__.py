"""Offline evaluation (counterpart of ``hgsfusion_tpu/eval``): the KITTI AP
core and the official View-of-Delft and TJ4DRadSet protocols, in numpy,
with the rotated overlap in C++ (``csrc/rotate_iou.cc``)."""
