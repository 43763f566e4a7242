"""Data-transfer overhead models (paper Sec. IV-A).

MPI messages follow the Hockney model (Eq. 1); message-free communication
replaces the transfer with a two-sided atomic handshake (Eq. 2) — the sender
signals ready-to-read, the receiver signals ready-to-write.  ``LogGPTransfer``
is the drop-in alternative the paper suggests (Sec. VI).

The PyTorch counterpart of ``repro.core.transfer``.  Every model is linear
in three per-site traffic aggregates (``SiteTraffic``), so the scalar
per-call path and the sweep share ``transfer_from_traffic``: model fields
are Python floats (one scenario) or ``(n_scenarios, 1)`` float64 tensors (a
sweep), traffic fields are Python numbers or ``(n_sites,)`` float64 tensors,
and the arithmetic broadcasts.  The formulas are plain arithmetic, so they
need no array namespace.

``TRANSFER_MODELS`` is the name registry behind ``ParamGrid``'s categorical
``mpi_transfer=`` / ``free_transfer=`` axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

from .params import ModelParams
from .traces import CallSite


@dataclass(frozen=True)
class SiteTraffic:
    """Per-call-site comm aggregates — sufficient statistics for all
    transfer models (fields may be scalars or per-site tensors)."""

    n_msgs: object       # Σ count
    total_bytes: object  # Σ count · bytes
    gap_bytes: object    # Σ count · max(0, bytes − 1)   (LogGP's (k−1)·G term)

    @staticmethod
    def of(site: CallSite) -> "SiteTraffic":
        return SiteTraffic(
            n_msgs=sum(c.count for c in site.comms),
            total_bytes=sum(c.count * c.bytes for c in site.comms),
            gap_bytes=sum(c.count * max(0, c.bytes - 1) for c in site.comms))


class TransferModel(Protocol):
    def transfer_ns(self, site: CallSite) -> float: ...
    def transfer_from_traffic(self, t: SiteTraffic): ...


@dataclass(frozen=True)
class HockneyTransfer:
    """Eq. 1:  T = sum over traces of (MPI_LAT + bytes / MPI_BW)."""

    lat_ns: float
    bw_Bpns: float

    @staticmethod
    def from_params(p: ModelParams) -> "HockneyTransfer":
        return HockneyTransfer(lat_ns=p.mpi_lat_ns, bw_Bpns=p.mpi_bw_Bpns)

    def message_ns(self, nbytes: float) -> float:
        return self.lat_ns + nbytes / self.bw_Bpns

    def transfer_from_traffic(self, t: SiteTraffic):
        return t.n_msgs * self.lat_ns + t.total_bytes / self.bw_Bpns

    def transfer_ns(self, site: CallSite) -> float:
        return float(self.transfer_from_traffic(SiteTraffic.of(site)))


@dataclass(frozen=True)
class MessageFreeTransfer:
    """Eq. 2:  T = sum over traces of 2 * CXL_ATOMIC_LAT.

    Only the synchronization handshake remains; the data movement itself is
    accounted for by the *access* model (the receiver loads straight from the
    shared buffer).
    """

    atomic_lat_ns: float

    @staticmethod
    def from_params(p: ModelParams) -> "MessageFreeTransfer":
        return MessageFreeTransfer(atomic_lat_ns=p.cxl_atomic_lat_ns)

    def message_ns(self, nbytes: float) -> float:
        del nbytes  # size-independent by design
        return 2.0 * self.atomic_lat_ns

    def transfer_from_traffic(self, t: SiteTraffic):
        return 2.0 * self.atomic_lat_ns * t.n_msgs

    def transfer_ns(self, site: CallSite) -> float:
        return float(self.transfer_from_traffic(SiteTraffic.of(site)))


@dataclass(frozen=True)
class LogGPTransfer:
    """LogGP alternative (Sec. VI): T = L + 2o + (bytes - 1) * G."""

    L_ns: float
    o_ns: float
    G_ns_per_byte: float

    @staticmethod
    def from_params(p: ModelParams) -> "LogGPTransfer":
        """Hockney-calibrated LogGP point: L = the measured MPI latency,
        zero explicit overhead, G = the inverse measured bandwidth."""
        return LogGPTransfer(L_ns=p.mpi_lat_ns, o_ns=0.0,
                             G_ns_per_byte=1.0 / p.mpi_bw_Bpns)

    def message_ns(self, nbytes: float) -> float:
        return self.L_ns + 2.0 * self.o_ns + max(0.0, nbytes - 1) * self.G_ns_per_byte

    def transfer_from_traffic(self, t: SiteTraffic):
        return t.n_msgs * (self.L_ns + 2.0 * self.o_ns) \
            + t.gap_bytes * self.G_ns_per_byte

    def transfer_ns(self, site: CallSite) -> float:
        return float(self.transfer_from_traffic(SiteTraffic.of(site)))


#: Name -> factory for ``ParamGrid``'s categorical transfer-model axes.
#: Each factory accepts anything with ``ModelParams``'s transfer fields —
#: the real dataclass (scalar fields) or the sweep view (``(S, 1)`` tensors).
TRANSFER_MODELS = {
    "hockney": HockneyTransfer.from_params,
    "loggp": LogGPTransfer.from_params,
    "message_free": MessageFreeTransfer.from_params,
    "two_atomic": MessageFreeTransfer.from_params,
}
