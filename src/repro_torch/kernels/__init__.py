# Hand-written CUDA kernels of the datapath (sources in repro_torch/csrc),
# each with a plain PyTorch version in its ref.py.
