"""PyTorch + CUDA port of FlexiNS: the verbs datapath, the KV-cache
transfer leg and the serving model.

The JAX package `repro` is the reference; this package mirrors its
module names (`core.*`, `verbs.*`, `serve.*`, `models.*`, `kernels.*`)
and runs on an NVIDIA H100 by default (`repro_torch.device`). Every
device step the reference wrote as a TPU kernel is a hand-written CUDA
kernel (`csrc/`), built with nvcc at first use; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead, which is how the
tests hold the port against the reference.

Importing the package needs neither a card nor a compiler.
"""
