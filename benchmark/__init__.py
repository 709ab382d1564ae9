"""The benchmark of ``legged_tracking_torch``, the PyTorch and CUDA port.

    python -m benchmark.run --workload tunnel-train-4096 --seed 7 --seconds 30 --trace 0

``README.md`` beside this file says how a cell, a configuration and a
per-layer metric are added as files of their own.
"""
