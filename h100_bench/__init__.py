"""The port's H100 benchmark: one cell (configuration x traffic) a run.

`python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; README.md says how configurations, traffic mixes and
per-layer metrics are added as files of their own.
"""
