"""hydracore_tpu_torch — the PyTorch/CUDA port of hydracore_tpu.

A second package beside the JAX one: the same renderer in PyTorch, with
every Pallas TPU kernel on the ported path rewritten by hand for NVIDIA
Hopper (CUDA C++ under csrc/). It imports nothing of JAX or of
hydracore_tpu and mirrors the JAX package's layout:

  scene/        statefile and .vsgf loaders, scene assembler, procedural
                scene builder, material/light compilers, SceneData, a
                demo statefile library writer (library)
  bvh/          SAH BVH builder (numpy + native C++), the cluster cut, its
                partition into chunks, the two-level instanced layout
  ops/          RNG, intersection, cluster traversal kernels B1/B2/B3, dispatch
  bsdf/         BSDF sample/eval, the multiscatter energy tables and
                their bakers
  lights/       light sampling (NEE and emission), env pdf tables
  integrators/  wavefront MIS+NEE path tracer (render, render_passes) and
                its other schedules, light tracing (lt), the G-buffer and
                adaptive sampling (gbuffer), bidirectional path tracing
                (bdpt), Metropolis light transport (mlt, mmlt), the numpy
                oracle
  parallel/     multi-device rendering over a torch.distributed group
                (mesh: NCCL on the card, gloo on the CPU)
  app/          the front ends: the command line (cli, run with
                python -m hydracore_tpu_torch.app.cli), the interactive
                viewer served over HTTP (viewer), host camera plugins
                (cam_plugin)
  utils/        math, device choice, native builds, the framebuffer and
                checkpoints, denoise filters, per-stage statistics, the
                cross-process shared image
  csrc/         CUDA and C++ sources, built at first use into _build/
"""
