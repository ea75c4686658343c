"""Software IBV-verbs compatibility layer (paper §4), torch port.

One API over the FlexiNS engines:

  ProtectionDomain/MemoryRegion  -> T4 offload-engine DMA regions (tensors)
  QueuePair (RESET->INIT->RTR->RTS), post_send/post_recv  -> the send path
  CompletionQueue.poll  -> T3 DMA-only notification ring
  custom opcodes via post_send  -> T4 handler dispatch (Table 2)

The loopback datapath, the routed multi-pod `Fabric` (connection
manager, fabric-scope SRQ, RNR retry), its seeded `FaultModel`, the
`RateController`, and the `MeshTransport` wire.
"""
from repro_torch.verbs.cq import CompletionQueue, CQOverrunError, WorkCompletion
from repro_torch.verbs.fabric import (ConnectionManager, Fabric,
                                      FabricAddress, FabricEndpoint)
from repro_torch.verbs.faults import FaultModel
from repro_torch.verbs.pd import MemoryRegion, ProtectionDomain
from repro_torch.verbs.qp import (ENOMEMError, QPState, QPStateError,
                                  QueuePair, RecvWR, SendWR)
from repro_torch.verbs.ratectl import RateController
from repro_torch.verbs.srq import SharedReceiveQueue
from repro_torch.verbs.transport import (SCALAR_DISPATCH_MAX,
                                         LoopbackTransport, MeshTransport,
                                         VerbsPair, connect, two_sided_send)
from repro_torch.verbs.wqe import (IBV_WC_ACCESS_ERR, IBV_WC_RECV,
                                   IBV_WC_RETRY_EXC_ERR, IBV_WC_RNR_ERR,
                                   IBV_WC_SUCCESS, IBV_WC_WR_FLUSH_ERR,
                                   IBV_WR_RDMA_READ, IBV_WR_RDMA_WRITE,
                                   IBV_WR_SEND, INLINE_MAX_BYTES)

__all__ = [
    "CompletionQueue", "CQOverrunError", "WorkCompletion",
    "ConnectionManager", "Fabric", "FabricAddress", "FabricEndpoint",
    "FaultModel", "RateController",
    "MemoryRegion", "ProtectionDomain",
    "ENOMEMError", "QPState", "QPStateError", "QueuePair", "RecvWR",
    "SendWR", "SharedReceiveQueue",
    "SCALAR_DISPATCH_MAX", "LoopbackTransport", "MeshTransport",
    "VerbsPair", "connect", "two_sided_send",
    "IBV_WC_ACCESS_ERR", "IBV_WC_RECV", "IBV_WC_RNR_ERR",
    "IBV_WC_RETRY_EXC_ERR", "IBV_WC_SUCCESS", "IBV_WC_WR_FLUSH_ERR",
    "IBV_WR_RDMA_READ", "IBV_WR_RDMA_WRITE", "IBV_WR_SEND",
    "INLINE_MAX_BYTES",
]
