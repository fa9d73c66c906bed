"""Memory-tier model, transfer cost model and interconnect topology.

The paper's cost model (Figures 3 and 7) is a bandwidth/latency model over
two links: host<->GPU over PCIe 5.0 and GPU<->GPU over 12 NVLink links.  Our
TPU adaptation keeps the same *structure* — a slow host link and a fast peer
link — with v5e-class constants.  Both parameter sets ship here so the paper
benchmarks (fig3/fig7) can run with the paper's hardware and the roofline
with the TPU's.

:class:`Topology` generalises the single fast/slow pair to an N-device
interconnect: every peer device has its own :class:`LinkSpec` from the
compute device, so transfers to distinct peers can ride distinct link
lanes in parallel and placement can trade link bandwidth against device
churn.  :class:`HardwareModel` (one anonymous peer) survives as the
2-device compat surface — ``Topology.link(..., device=None)`` degrades to
exactly ``HardwareModel.link``.

All times are seconds, sizes bytes.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


class Tier(enum.Enum):
    LOCAL_HBM = "local"    # compute device HBM (authoritative for hot state)
    PEER_HBM = "peer"      # harvested peer-device HBM (transient, revocable)
    HOST_DRAM = "host"     # host memory (authoritative backing store)
    LOCAL_SSD = "ssd"      # local NVMe cold tier (capacity, not speed)


class Fidelity(enum.Enum):
    """Precision a KV block travels and parks at on the cold tiers.

    Full fidelity (FP16) is the wire format the seed shipped: a block's
    ``nbytes`` IS what moves.  The quantized fidelities shrink the wire
    and parking footprint by an integer ratio (per-block absmax scale —
    see ``kernels/harvest_copy``): INT8 and FP8-e4m3 halve a bf16 block,
    INT4 packs two weights per byte for a 4x cut.  The LOCAL slot always
    holds full precision — fidelity is a property of the *demoted* copy,
    cleared when the block is dequantized back on reload.
    """
    FP16 = "fp16"
    INT8 = "int8"
    FP8 = "fp8"
    INT4 = "int4"

    @property
    def ratio(self) -> Tuple[int, int]:
        """(numerator, denominator) of quantized-bytes / fp16-bytes."""
        return _FIDELITY_RATIO[self]

    @property
    def is_quantized(self) -> bool:
        return self is not Fidelity.FP16

    def wire_bytes(self, nbytes: int) -> int:
        """Bytes a block of full-precision size ``nbytes`` occupies at
        this fidelity: exact for FP16 (seed goldens stay bit-exact), the
        integer-ratio cut plus one f32 per-block scale otherwise."""
        if self is Fidelity.FP16:
            return int(nbytes)
        num, den = _FIDELITY_RATIO[self]
        return int(nbytes) * num // den + FIDELITY_SCALE_BYTES


_FIDELITY_RATIO = {
    Fidelity.FP16: (1, 1),
    Fidelity.INT8: (1, 2),
    Fidelity.FP8: (1, 2),
    Fidelity.INT4: (1, 4),
}

#: per-block quantization metadata (one f32 absmax scale) that rides the
#: wire with every quantized block
FIDELITY_SCALE_BYTES = 4


@dataclass(frozen=True)
class LinkSpec:
    bandwidth: float       # bytes / second (effective, not marketing peak)
    latency: float         # per-transfer fixed cost (s)
    #: number of link-disjoint physical paths this link aggregates (12 NVLink
    #: links, 4 torus ICI paths).  ``bandwidth`` is the AGGREGATE across all
    #: paths; a single chunk stream striped onto one path sustains
    #: ``bandwidth / paths``.  The flat cost model ignores this — only the
    #: :class:`~repro_torch.core.coalesce.TransferPlanner`'s chunked striping
    #: schedules individual paths.
    paths: int = 1

    def transfer_time(self, nbytes: int) -> float:
        return self.latency + nbytes / self.bandwidth

    @property
    def path_bandwidth(self) -> float:
        """Effective bandwidth of ONE of the link-disjoint paths."""
        return self.bandwidth / max(self.paths, 1)


# Local NVMe used when a preset does not calibrate its own: a datacenter
# gen4 drive sustains ~5 GB/s at ~120 us submission+seek overhead.
DEFAULT_SSD_LINK = LinkSpec(bandwidth=5e9, latency=120e-6)


@dataclass(frozen=True)
class HardwareModel:
    name: str
    peer_link: LinkSpec    # fast device<->device path
    host_link: LinkSpec    # device<->host path
    hbm_bw: float          # bytes/s local HBM
    peak_flops: float      # bf16 FLOP/s per chip
    hbm_bytes: int         # HBM capacity per device
    ssd_link: LinkSpec = DEFAULT_SSD_LINK   # local NVMe cold-tier path

    def link(self, src: Tier, dst: Tier) -> LinkSpec:
        pair = {src, dst}
        if pair == {Tier.LOCAL_HBM}:
            return LinkSpec(self.hbm_bw, 0.0)
        if Tier.LOCAL_SSD in pair:
            # SSD checked before host: a host->SSD spill and a
            # device->SSD writeback both bottleneck on the drive
            return self.ssd_link
        if Tier.HOST_DRAM in pair:
            return self.host_link
        return self.peer_link

    def transfer_time(self, nbytes: int, src: Tier, dst: Tier) -> float:
        return self.link(src, dst).transfer_time(nbytes)


# The paper's testbed: Azure NC80adis H100 v5 — 2x H100, PCIe 5.0,
# 12 NVLink links between the two GPUs.  Effective bandwidths/latencies are
# calibrated so the chunk-transfer microbenchmark (Fig 3) reproduces the
# paper's measured 7.5x (Phi-tiny expert, ~15 MiB) to 9.5x (Mixtral expert,
# ~336 MiB) peer/host speedup band: 12 NVLink4 links sustain ~425 GB/s with
# ~25 us transfer setup; PCIe5 x16 with driver staging sustains ~44 GB/s
# effective with ~110 us setup (pageable-copy staging dominates small sizes).
H100_NVLINK = HardwareModel(
    name="h100-nvlink-2gpu",
    peer_link=LinkSpec(bandwidth=425e9, latency=34.2e-6, paths=12),
    host_link=LinkSpec(bandwidth=44e9, latency=194e-6),
    hbm_bw=3.35e12,
    peak_flops=989e12,
    hbm_bytes=80 * 2**30,
    # local NVMe (gen5 datacenter drive behind the same PCIe switch as the
    # host path): ~6.5 GB/s effective sequential, ~110 us submission cost
    ssd_link=LinkSpec(bandwidth=6.5e9, latency=110e-6),
)

# TPU v5e-class chip (the production-mesh target of this repo).
# ICI: ~50 GB/s per link; a 2D-torus chip has 4 links, but a point-to-point
# fetch uses one path -> 45 GB/s effective single-path, 4x when striped.
# Host path: PCIe gen3-class host interconnect, ~16 GB/s effective.
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    peer_link=LinkSpec(bandwidth=45e9, latency=6e-6),
    host_link=LinkSpec(bandwidth=16e9, latency=25e-6),
    hbm_bw=819e9,
    peak_flops=197e12,
    hbm_bytes=16 * 2**30,
    # host-attached NVMe over the shared gen3-class host interconnect:
    # ~3 GB/s effective, ~175 us submission cost
    ssd_link=LinkSpec(bandwidth=3e9, latency=175e-6),
)

HARDWARE = {m.name: m for m in (H100_NVLINK, TPU_V5E)}


# ---------------------------------------------------------------------------
# interconnect topology
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Topology:
    """An N-device interconnect: per-peer-device links from the compute device.

    ``hardware`` supplies the per-chip constants (local HBM, peak FLOPs,
    host link) and the *default* peer link used when a transfer names no
    device — the 2-device compat path, bit-exact with the flat
    :class:`HardwareModel` cost model.  ``peer_links`` maps each harvestable
    peer device id to the link it is reached over; distinct devices get
    distinct directional lanes in the
    :class:`~repro_torch.core.store.TransferEngine`, so transfers to different
    peers pipeline in parallel on the simulated clock.

    Scale-out: ``device_hosts`` places peer devices on hosts (host 0 is the
    compute device's own host and the default for unmapped devices).  A
    device on a remote host is reached over that host's DCN link — its
    ``peer_links`` entry IS the inter-host :class:`LinkSpec` (the preset
    factories enforce this), so the flat cost model, coalescing, striping
    and fidelity wire-bytes all price DCN traffic with no special cases.
    The :class:`~repro_torch.core.store.TransferEngine` gives each remote host a
    shared ``dcn{h}_in``/``dcn{h}_out`` lane pair (one NIC per host pair —
    a host's devices contend for it, unlike per-device NVLink lanes).
    """
    name: str
    hardware: HardwareModel
    peer_links: Dict[int, LinkSpec] = field(default_factory=dict)
    #: peer device id -> host index (0 = the compute device's host).
    device_hosts: Dict[int, int] = field(default_factory=dict)
    #: remote host index -> DCN link from host 0 to that host.
    dcn_links: Dict[int, LinkSpec] = field(default_factory=dict)

    def __post_init__(self):
        for d, h in self.device_hosts.items():
            if d not in self.peer_links:
                raise ValueError(f"device_hosts names unknown device {d}")
            if h and h not in self.dcn_links:
                raise ValueError(f"device {d} on host {h} but no dcn_links "
                                 f"entry for host {h}")

    @property
    def devices(self) -> Tuple[int, ...]:
        """Harvestable peer device ids, ascending."""
        return tuple(sorted(self.peer_links))

    @property
    def num_peers(self) -> int:
        return len(self.peer_links)

    # ------------------------------------------------------------- hosts
    @property
    def hosts(self) -> Tuple[int, ...]:
        """All host indices, ascending (host 0 always present)."""
        return tuple(sorted({0, *self.device_hosts.values()}))

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def host_of(self, device: Optional[int]) -> int:
        """Host a peer device lives on (0 = local host, the default)."""
        if device is None:
            return 0
        return self.device_hosts.get(device, 0)

    def devices_on(self, host: int) -> Tuple[int, ...]:
        """Peer device ids on one host, ascending."""
        return tuple(d for d in self.devices if self.host_of(d) == host)

    def dcn_link(self, host: int) -> LinkSpec:
        """The DCN link from host 0 to a remote host."""
        return self.dcn_links[host]

    def peer_link(self, device: Optional[int] = None) -> LinkSpec:
        if device is None:
            return self.hardware.peer_link
        return self.peer_links.get(device, self.hardware.peer_link)

    def link(self, src: Tier, dst: Tier,
             device: Optional[int] = None) -> LinkSpec:
        pair = {src, dst}
        if pair == {Tier.LOCAL_HBM}:
            return LinkSpec(self.hardware.hbm_bw, 0.0)
        if Tier.LOCAL_SSD in pair:
            return self.hardware.ssd_link
        if Tier.HOST_DRAM in pair:
            return self.hardware.host_link
        return self.peer_link(device)

    def transfer_time(self, nbytes: int, src: Tier, dst: Tier,
                      device: Optional[int] = None) -> float:
        return self.link(src, dst, device).transfer_time(nbytes)

    def device_budgets(self, harvestable_bytes: int) -> Dict[int, int]:
        """Uniform per-peer harvestable budget map (allocator constructor
        shorthand for the presets)."""
        return {d: int(harvestable_bytes) for d in self.devices}


def nvlink_2gpu() -> Topology:
    """The paper's testbed: 2x H100, all 12 NVLink links to the single peer.
    This is the compat preset — one peer (device 1), the same link constants
    as :data:`H100_NVLINK`, and the legacy ``peer_in``/``peer_out`` lane
    names, so seed goldens stay bit-exact."""
    return Topology("h100-nvlink-2gpu",
                    H100_NVLINK, {1: H100_NVLINK.peer_link})


def nvlink_mesh(num_peers: int) -> Topology:
    """NVSwitch-fabric mesh (HGX board or NVLink-switched domain): every
    peer reachable at full per-pair NVLink bandwidth, so the fabric's
    parallelism is across *lanes*, not shared bandwidth.  ``num_peers=1``
    coincides with the 2-GPU preset's link constants; 8 peers model one
    compute GPU harvesting a 9-GPU NVLink domain (switched domains span
    boards — NVL-class racks reach 72)."""
    if not 1 <= num_peers <= 16:
        raise ValueError(f"num_peers={num_peers}: cap one NVLink-switched "
                         "domain at 16 peers here (NVL72-scale domains "
                         "deserve their own calibrated preset)")
    return Topology(f"h100-nvlink-mesh-{num_peers + 1}gpu", H100_NVLINK,
                    {d: H100_NVLINK.peer_link
                     for d in range(1, num_peers + 1)})


# PCIe-switch peer path: no NVLink — peer DMA hops through a shared PCIe5
# switch.  Effective per-pair bandwidth is the switch's x16 share with P2P
# overheads (~26 GB/s) and setup cost close to the host path's.
PCIE_P2P_LINK = LinkSpec(bandwidth=26e9, latency=150e-6)


def pcie_switch(num_peers: int) -> Topology:
    """Fallback topology for boxes without NVLink: peers behind one PCIe
    switch.  Distinct devices still get distinct duplex lanes (the switch
    is non-blocking for disjoint endpoint pairs) but each lane is slow."""
    return Topology(f"pcie-switch-{num_peers + 1}gpu", H100_NVLINK,
                    {d: PCIE_P2P_LINK for d in range(1, num_peers + 1)})


def tpu_v5e_torus(grid: Tuple[int, int] = (2, 2),
                  stripe: bool = True) -> Topology:
    """TPU v5e 2D-torus ICI.  The compute chip sits at (0, 0); every other
    chip in the ``grid`` is a harvestable peer.  A point-to-point fetch on
    one ICI path sustains ~45 GB/s; with ``stripe`` the transfer is striped
    over the torus's 4 link-disjoint paths (4x bandwidth — the
    production-mesh configuration).  Per-hop switching adds latency, so
    distant peers are reachable but measurably worse — exactly the gradient
    topology-aware placement exploits."""
    nx, ny = grid
    if nx * ny < 2:
        raise ValueError(f"grid {grid}: need at least one peer chip")
    base = TPU_V5E.peer_link
    links: Dict[int, LinkSpec] = {}
    for x in range(nx):
        for y in range(ny):
            if (x, y) == (0, 0):
                continue
            hops = min(x, nx - x) + min(y, ny - y)   # torus wrap-around
            bw = base.bandwidth * (4 if stripe else 1)
            links[x * ny + y] = LinkSpec(bandwidth=bw,
                                         latency=base.latency * hops,
                                         paths=4 if stripe else 1)
    return Topology(f"tpu-v5e-torus-{nx}x{ny}" + ("-striped" if stripe else ""),
                    TPU_V5E, links)


# ---------------------------------------------------------------------------
# multi-host (DCN) presets
# ---------------------------------------------------------------------------

# Inter-host datacenter-network links.  A GPU cluster's 4x400G RDMA rails
# sustain ~50 GB/s effective between one host pair at ~12 us setup
# (GPUDirect-RDMA, QP already established), spread over many switch-disjoint
# paths — so chunked striping keeps paying off across hosts.  The TPU-pod
# DCN path is slimmer: ~25 GB/s effective at ~30 us.
H100_DCN_LINK = LinkSpec(bandwidth=50e9, latency=12e-6, paths=16)
V5E_DCN_LINK = LinkSpec(bandwidth=25e9, latency=30e-6, paths=8)


def multihost(base: Topology, num_hosts: int, remote_peers: int,
              dcn: LinkSpec, name: Optional[str] = None) -> Topology:
    """Extend a single-host topology with ``num_hosts - 1`` remote hosts,
    each contributing ``remote_peers`` harvestable devices over one shared
    ``dcn`` link.  Remote device ids continue densely after the local ones;
    their ``peer_links`` entry is the DCN spec itself so every existing
    cost-model seam (flat estimate, coalesce, stripe, fidelity wire bytes)
    prices them correctly with no special-casing."""
    if num_hosts < 2:
        raise ValueError(f"num_hosts={num_hosts}: need at least one remote "
                         "host (use the single-host preset otherwise)")
    links = dict(base.peer_links)
    device_hosts = dict(base.device_hosts)
    nxt = max(links, default=0) + 1
    for h in range(1, num_hosts):
        for _ in range(remote_peers):
            links[nxt] = dcn
            device_hosts[nxt] = h
            nxt += 1
    dcn_links = {h: dcn for h in range(1, num_hosts)}
    return Topology(name or f"{base.name}-{num_hosts}host",
                    base.hardware, links, device_hosts, dcn_links)


def h100_dcn(num_hosts: int = 2, local_peers: int = 1,
             remote_peers: int = 3) -> Topology:
    """Scale-out H100 preset: one NVLink domain plus ``num_hosts - 1``
    remote hosts harvested over the RDMA fabric.  Each remote host exposes
    ``remote_peers`` idle GPUs whose HBM is reachable at DCN cost; all of a
    host's devices share that host's ``dcn{h}`` lane pair."""
    return multihost(nvlink_mesh(local_peers) if local_peers > 1
                     else nvlink_2gpu(),
                     num_hosts, remote_peers, H100_DCN_LINK,
                     name=f"h100-dcn-{num_hosts}host")


def v5e_dcn(num_hosts: int = 2, remote_peers: int = 3) -> Topology:
    """Scale-out TPU v5e preset: one 2x2 ICI torus plus remote v5e hosts
    over the pod DCN."""
    return multihost(tpu_v5e_torus((2, 2)), num_hosts, remote_peers,
                     V5E_DCN_LINK, name=f"v5e-dcn-{num_hosts}host")


#: CLI-facing presets (``--topology`` on launch/serve.py, fig8 sweeps).
TOPOLOGIES = {
    "nvlink-2gpu": nvlink_2gpu,
    "nvlink-mesh-4": lambda: nvlink_mesh(3),
    "nvlink-mesh-8": lambda: nvlink_mesh(7),
    "pcie-switch-4": lambda: pcie_switch(3),
    "v5e-torus-2x2": lambda: tpu_v5e_torus((2, 2)),
    "v5e-torus-4x2": lambda: tpu_v5e_torus((4, 2)),
    "h100-dcn-2host": lambda: h100_dcn(2),
    "h100-dcn-4host": lambda: h100_dcn(4),
    "v5e-dcn-2host": lambda: v5e_dcn(2),
    "v5e-dcn-4host": lambda: v5e_dcn(4),
}


def get_topology(name: str) -> Topology:
    try:
        return TOPOLOGIES[name]()
    except KeyError:
        raise KeyError(f"unknown topology {name!r} — one of "
                       f"{sorted(TOPOLOGIES)}") from None


def expert_bytes(cfg, dtype_bytes: int = 2) -> int:
    """Size of one expert's parameters (the unit the Expert Rebalancer moves)."""
    mc = cfg.moe
    mats = 3 if cfg.gated_mlp else 2
    return mats * cfg.d_model * mc.d_ff_expert * dtype_bytes


def kv_entry_bytes(num_layers: int, num_kv_heads: int, head_dim: int,
                   dtype_bytes: int = 2) -> int:
    """Bytes of one token's KV across all layers (the paper's 'KV cache entry')."""
    return num_layers * 2 * num_kv_heads * head_dim * dtype_bytes


def kv_block_bytes(cfg, block_size: int, dtype_bytes: int = 2) -> int:
    from repro_torch.models.model import num_kv_layers
    return kv_entry_bytes(num_kv_layers(cfg), cfg.num_kv_heads,
                          cfg.resolved_head_dim, dtype_bytes) * block_size
