"""The benchmark of rucene_tpu_torch, the PyTorch and CUDA port, on NVIDIA
cards: ``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (portbench/run.py). BENCHMARK.json at the repository's root
names the cells, configurations and metrics; PERF.md says why each."""
