"""The kernel lab: the JAX package's probe tools (tools/) ported to the card.

Each module is named after the tool it ports and holds one CUDA kernel
(csrc/lab_*.cu, built at first use), its plain PyTorch version, a launch
counter and main(variant, device="cuda"); each runs as
`python -m hydracore_tpu_torch.tools.<name> [variant]` and prints the
tool's lines with the card's name and power limit beside every time:

  bench_pallas_gather  T7  random row gathers (csrc/lab_gather.cu)
  proto_prims          T6  ten small primitive probes (csrc/lab_prims.cu)
  proto_subvisit       T5  a cluster per ray block against a cluster per
                           band of rays (csrc/lab_subvisit.cu)
  exp_kernel_cost      T1  the cluster kernel's time split into floor, box
                           scan, compaction and the whole kernel
                           (csrc/lab_cluster_cost.cu, and B1 for "full")
"""
