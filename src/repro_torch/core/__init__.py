"""The paper's primary contribution, ported to PyTorch and CUDA:
accelerator-offloaded hashing for a content-addressable storage system —
the hashing kernels (repro_torch.kernels), the CrystalGPU task runtime,
the MosaStore-analog CA store and client SAI, plus chunking / integrity
substrates."""
from repro_torch.core.castore import (MetadataManager, StorageNode,  # noqa: F401
                                      BlockMeta, NodeFailure,
                                      RecoveryReport, make_store,
                                      open_durable_store)
from repro_torch.core.blockstore import BlockStore  # noqa: F401
from repro_torch.core.wal import WALError, WriteAheadLog  # noqa: F401
from repro_torch.core.faultinject import CrashPoint, FaultInjector  # noqa: F401
from repro_torch.core.crystal import CrystalGPU, Job, default_engine  # noqa: F401
from repro_torch.core.sai import (SAI, SAIConfig, ReadFuture,  # noqa: F401
                                  StoreIOError, WriteFuture, WriteStats,
                                  pack_blocks)
from repro_torch.core.noderuntime import (ClusterRuntime,  # noqa: F401
                                          NodeRuntime, NodeRuntimeConfig)
from repro_torch.core import chunking, integrity  # noqa: F401
