"""The port's counterparts of the repository's ``scripts/``: the validation
harness (the phantom task, the OOD method comparison and its table) and the
throughput tools. Each module runs as ``python -m
maxstyle_tpu_torch.scripts.<name>`` on the GPU, or on the CPU when given
``--device cpu``."""
