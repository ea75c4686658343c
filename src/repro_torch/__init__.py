"""PyTorch + CUDA port of the FlexiNS verbs datapath.

The JAX package `repro` is the reference; this package mirrors its
module names (`core.offload_engine`, `core.notification`, `verbs.*`,
`kernels.*`) and runs on an NVIDIA H100 by default (`repro_torch.device`).
Every device step of the datapath is a hand-written CUDA kernel
(`csrc/`), built with nvcc at first use; on a CPU tensor each kernel
wrapper runs its plain PyTorch version instead, which is how the tests
hold the port against the reference.

Importing the package needs neither a card nor a compiler.
"""
