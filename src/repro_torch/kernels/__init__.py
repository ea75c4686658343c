# Hand-written CUDA kernels (sources in repro_torch/csrc): the datapath's
# row copies and CQ ring, the T2 page ingest and the prefill attention,
# each with a plain PyTorch version in its ref.py.
