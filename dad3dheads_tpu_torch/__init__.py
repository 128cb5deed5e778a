"""dad3dheads_tpu_torch — the PyTorch + CUDA port of ``dad3dheads_tpu``.

The JAX package beside it is the reference; every module here mirrors the
module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax``, ``flax`` or anything of the JAX package; ``constants`` and
``assets`` (with the asset files under ``assets/``) are its own copies.

Layers (bottom-up):
  core        FLAME decode, rotation, LBS, projection, 68 landmarks, HeadMesh
  ops         hand-written Hopper kernels (``csrc/*.cu``) as ``torch.library``
              custom operators (``dad3d::``) with their plain PyTorch
              versions: fused blendshapes and their backward, uint8
              normalize, frame crop/resize/normalize; the heatmap encoder
  models      DAD-3DNet (ResNet-50 + BiFPN + heads) as ``nn.Module``s
  weights     flax variables / msgpack checkpoints <-> torch state dict
  render      rasterizer kernel, lighting, PNCC, UV texture
  api         FaceMeshPredictor (predict_batch, predict_frames,
              predict_images), the deployment artifact (export_predictor,
              ExportedFaceMeshPredictor), demo processors
  data        synthetic training batches, bbox helpers, FlameDataset and
              DataLoader (the DAD-3DHeads on-disk format)
  losses      the four training losses over one shared FLAME decode
  metrics     NME, failure rates, soft IoU
  train       config, optimizers, schedulers, state, step, checkpoints, Trainer
  parallel    meshes, data parallelism over torch.distributed (global-batch
              BatchNorm, gradient and log all-reduce), the device prefetcher,
              head tensor parallelism
  benchmark_harness  the DAD-3DHeads evaluator, ground truth, submissions
  cli         predict, demo, train, make_dataset, benchmark, acceptance, export
"""

__version__ = "0.1.0"
