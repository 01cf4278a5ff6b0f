"""The benchmark of the PyTorch and CUDA port (``semantic_embeddings_torch``):
run one cell with ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
