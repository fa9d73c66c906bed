"""Harvest core of the port: the runtime that places, moves and accounts
for tiered objects (copied from ``repro.core``, numpy only), plus the
paged decode attention over the KV pools (PyTorch, kernel K1 on the card).

Public API (construct these):
  runtime     — HarvestRuntime: the facade composing allocator + monitor +
                policy + store; every entry point builds one of these
  store       — HarvestStore: generic tiered-object residency (local/peer/
                host/LOST), durability classes, TransferEngine, metrics

Components (the runtime wires these for you): allocator, policy, monitor,
tiers (the simulated H100/NVLink and TPU cost models and topologies),
rebalancer, kv_manager, coalesce, prefetch, prefix_cache,
paged_attention, and simulator (the CGOPipe pipeline model of the
paper's Fig 5/6: simulated tokens/s, numpy only).
"""
from repro_torch.core.allocator import (HarvestAllocator, HarvestHandle,
                                        RevokedError)
from repro_torch.core.coalesce import CoalesceConfig, TransferPlanner
from repro_torch.core.kv_manager import (BlockEntry, KVOffloadManager,
                                         ReloadOp, ReloadPlan)
from repro_torch.core.monitor import (ClusterTrace, ClusterTraceConfig,
                                      PeerMonitor)
from repro_torch.core.policy import (FIDELITY_POLICIES, BestFitPolicy,
                                     FairnessPolicy, FidelityPolicy,
                                     LocalityPolicy, PlacementRequest,
                                     StabilityPolicy, TopologyAwarePolicy,
                                     WorstFitPolicy)
from repro_torch.core.prefetch import Prefetcher, PrefetchConfig
from repro_torch.core.prefix_cache import (PrefixCache, PrefixCacheConfig,
                                           block_digests)
from repro_torch.core.rebalancer import ExpertRebalancer
from repro_torch.core.runtime import HarvestRuntime
from repro_torch.core.simulator import (AccessModelConfig, ExpertAccessModel,
                                        SimResult, simulate_moe_decode)
from repro_torch.core.store import (Durability, HarvestStore,
                                    LostObjectError, MetricsRegistry,
                                    ObjectEntry, Residency, Transfer,
                                    TransferEngine, channel_name)
from repro_torch.core.tiers import (HARDWARE, H100_DCN_LINK, H100_NVLINK,
                                    TOPOLOGIES, TPU_V5E, V5E_DCN_LINK,
                                    Fidelity, HardwareModel, LinkSpec, Tier,
                                    Topology, expert_bytes, get_topology,
                                    h100_dcn, kv_block_bytes, kv_entry_bytes,
                                    multihost, nvlink_2gpu, nvlink_mesh,
                                    pcie_switch, tpu_v5e_torus, v5e_dcn)
