"""The benchmark of the PyTorch and CUDA port, ``track_analyser_tpu_torch``,
on an NVIDIA H100: ``python -m h100_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``BENCHMARK.json`` and ``PERF.md``."""
