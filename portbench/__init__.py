"""The benchmark of cuclarabel_torch: batched conic solves on one CUDA
card.  `python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell once (see run.py)."""
