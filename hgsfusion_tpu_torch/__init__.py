"""HGSFusion in PyTorch for one NVIDIA H100 (sm_90a).

The port of the ``hgsfusion_tpu`` JAX package, slice by slice. This package
serves and trains View-of-Delft frames through
``configs/hgsfusion_vod_pallas.yaml`` and ``configs/hgsfusion_vod_polar.yaml``
and evaluates them with the official VoD AP (``tools/test.py``); the TPU's
Pallas sampler kernels are replaced by the hand-written CUDA kernels in
``csrc/quad_sample.cu`` and ``csrc/quad_sample_bwd.cu``, and the Pallas
prototype of the gather view's fused sample + reduce by
``csrc/quad_sample_reduce.cu``. It imports neither JAX nor the JAX package.
"""
