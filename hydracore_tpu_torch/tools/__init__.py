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
  proto_cluster        T2  dense cluster traversal of synthetic clusters,
                           Moller-Trumbore or the Plucker "MXU" variant
                           (csrc/lab_cluster.cu); `all` runs the tool's
                           eight jobs, `full 16 1 1024` one of them
  proto_packet         T3  a 128-ray packet walk of the 8-wide BVH with a
                           shared stack (csrc/lab_packet.cu)
  proto_packet2        T4  the 1024-ray packet walk, the design of B4 in the
                           JAX package (csrc/lab_packet.cu, a second
                           instance of T3's template)
"""
