"""The benchmark of baikaldb_tpu_torch on one or four NVIDIA H100 cards:
``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``)."""
