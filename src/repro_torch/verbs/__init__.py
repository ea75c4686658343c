"""Software IBV-verbs compatibility layer (paper §4), torch port.

One API over the FlexiNS engines:

  ProtectionDomain/MemoryRegion  -> T4 offload-engine DMA regions (tensors)
  QueuePair (RESET->INIT->RTR->RTS), post_send/post_recv  -> the send path
  CompletionQueue.poll  -> T3 DMA-only notification ring
  custom opcodes via post_send  -> T4 handler dispatch (Table 2)

This slice carries the loopback datapath; the routed `Fabric`, its fault
model and rate control, and the mesh wire come with the fabric slice.
"""
from repro_torch.verbs.cq import CompletionQueue, CQOverrunError, WorkCompletion
from repro_torch.verbs.pd import MemoryRegion, ProtectionDomain
from repro_torch.verbs.qp import (ENOMEMError, QPState, QPStateError,
                                  QueuePair, RecvWR, SendWR)
from repro_torch.verbs.srq import SharedReceiveQueue
from repro_torch.verbs.transport import (SCALAR_DISPATCH_MAX,
                                         LoopbackTransport, VerbsPair,
                                         connect, two_sided_send)
from repro_torch.verbs.wqe import (IBV_WC_ACCESS_ERR, IBV_WC_RECV,
                                   IBV_WC_RETRY_EXC_ERR, IBV_WC_RNR_ERR,
                                   IBV_WC_SUCCESS, IBV_WC_WR_FLUSH_ERR,
                                   IBV_WR_RDMA_READ, IBV_WR_RDMA_WRITE,
                                   IBV_WR_SEND, INLINE_MAX_BYTES)

__all__ = [
    "CompletionQueue", "CQOverrunError", "WorkCompletion",
    "MemoryRegion", "ProtectionDomain",
    "ENOMEMError", "QPState", "QPStateError", "QueuePair", "RecvWR",
    "SendWR", "SharedReceiveQueue",
    "SCALAR_DISPATCH_MAX", "LoopbackTransport", "VerbsPair", "connect",
    "two_sided_send",
    "IBV_WC_ACCESS_ERR", "IBV_WC_RECV", "IBV_WC_RNR_ERR",
    "IBV_WC_RETRY_EXC_ERR", "IBV_WC_SUCCESS", "IBV_WC_WR_FLUSH_ERR",
    "IBV_WR_RDMA_READ", "IBV_WR_RDMA_WRITE", "IBV_WR_SEND",
    "INLINE_MAX_BYTES",
]
