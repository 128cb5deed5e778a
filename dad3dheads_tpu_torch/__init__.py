"""dad3dheads_tpu_torch — the PyTorch + CUDA port of ``dad3dheads_tpu``.

The JAX package beside it is the reference; every module here mirrors the
module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax`` or ``flax``; from the JAX package it reuses only the numpy-only
``dad3dheads_tpu.constants`` and ``dad3dheads_tpu.assets``.

Layers (bottom-up):
  core        FLAME decode, rotation, LBS, projection, 68 landmarks (fp32)
  ops         hand-written Hopper kernels (``csrc/*.cu``) and their plain
              PyTorch versions: fused blendshapes, uint8 normalize
  models      DAD-3DNet (ResNet-50 + BiFPN + heads) as ``nn.Module``s
  weights     flax variables / msgpack checkpoints <-> torch state dict
  api         FaceMeshPredictor (batch path)
"""

__version__ = "0.1.0"
