"""The paper's LoS radio link (eq. 4, 5, 7), and the hop-count
interconnect of a pipeline's chips that the pipeline planner places
stages on (``ICIParams`` / ``ICIChannel``).

Unit note: the paper sets the thermal noise to -170 dBm and the packet
transmission duration to tau = 1e-4 s.  Taken as an *absolute* noise power,
every threshold in eq. (7) collapses to picowatts and the P_max sweep of
Fig. 2 would be vacuous.  -170 dBm is therefore read as a noise *density*
(dBm/Hz; thermal floor is -174 dBm/Hz), i.e. sigma^2 = N0 * B, and the
reliability constraint as per-packet (K_pkt bits within tau).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

DBM = 1e-3  # watts per milliwatt


def dbm_to_watts(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * DBM


@dataclass(frozen=True)
class RadioParams:
    """Constants from Section IV of the paper."""

    h0: float = 1e-5                 # median mean path gain @ d0 = 1 m
    noise_density_dbm: float = -170.0  # dBm/Hz (see unit note above)
    bandwidth_hz: float = 10e6       # B_{i,k}: 10 or 20 MHz in the paper
    tau: float = 1e-4                # packet transmission duration [s]
    packet_bits: float = 12_000.0    # K_pkt: one 1500-byte packet
    p_max_watts: float = 0.120       # 120 mW

    @property
    def noise_watts(self) -> float:
        return dbm_to_watts(self.noise_density_dbm) * self.bandwidth_hz


class RadioChannel:
    """The paper's LoS channel: gain eq. (4), rate eq. (5), threshold eq. (7)."""

    def __init__(self, params: RadioParams | None = None):
        self.params = params or RadioParams()

    # -- eq. (4) -----------------------------------------------------------
    def gain(self, d: np.ndarray | float) -> np.ndarray:
        d = np.maximum(np.asarray(d, dtype=np.float64), 1.0)  # d0 = 1 m ref
        return self.params.h0 / d ** 2

    # -- eq. (5) -----------------------------------------------------------
    def rate(self, d: np.ndarray | float, p_watts: np.ndarray | float) -> np.ndarray:
        """Achievable data rate [bit/s] at distance d, transmit power p."""
        p_rx = self.gain(d) * np.asarray(p_watts, dtype=np.float64)
        return self.params.bandwidth_hz * np.log2(1.0 + p_rx / self.noise())

    def noise(self) -> float:
        return self.params.noise_watts

    # -- eq. (7) -----------------------------------------------------------
    def power_threshold(self, d: np.ndarray | float,
                        bits: float | None = None) -> np.ndarray:
        """Minimum transmit power delivering ``bits`` within tau at distance d.

        P_th = sigma^2 / h * (exp(K ln2 / (B tau)) - 1)      (eq. 7)
        """
        p = self.params
        bits = p.packet_bits if bits is None else bits
        spectral = bits * math.log(2.0) / (p.bandwidth_hz * p.tau)
        return self.noise() / self.gain(d) * (math.exp(spectral) - 1.0)

    def feasible(self, d: np.ndarray | float) -> np.ndarray:
        """Link reliability feasibility: P_th <= P_max (Fig. 2 gating)."""
        return self.power_threshold(d) <= self.params.p_max_watts

    def transfer_time(self, bits: np.ndarray | float,
                      d: np.ndarray | float,
                      p_watts: np.ndarray | float) -> np.ndarray:
        """eq. (14): K_j / rho_{i,k}."""
        r = self.rate(d, p_watts)
        return np.asarray(bits, dtype=np.float64) / np.maximum(r, 1e-9)


@dataclass(frozen=True)
class ICIParams:
    """The chips' interconnect.  Every field is the caller's: the link
    rate and the cross-host rate from the hardware's data sheet, the hop
    latency and the topology from the deployment.  There is no default
    interconnect."""

    link_bw_bytes: float             # bytes/s of one chip-to-chip link
    hop_latency_s: float             # per-hop latency
    torus: tuple                     # physical topology, (x, y)
    dcn_bw_bytes: float              # cross-host bandwidth, bytes/s


class ICIChannel:
    """Hop-count channel on the chips' torus: the P2 'positions' analogue.

    Distance = Manhattan hop count on the (wrapped) torus; rate degrades with
    the number of hops a transfer serializes over, which is what makes stage
    placement on the physical torus (pipeline_opt) a real optimization.
    """

    def __init__(self, params: ICIParams):
        self.params = params

    def hops(self, a: tuple, b: tuple) -> int:
        d = 0
        for x, y, n in zip(a, b, self.params.torus):
            dx = abs(x - y)
            d += min(dx, n - dx)     # torus wrap
        return max(d, 0)

    def rate(self, hops: int) -> float:
        """Effective byte/s for a transfer serialized over ``hops`` links."""
        if hops <= 0:
            return float("inf")
        return self.params.link_bw_bytes / hops

    def transfer_time(self, bytes_: float, hops: int) -> float:
        if hops <= 0:
            return 0.0
        return bytes_ / self.rate(hops) + hops * self.params.hop_latency_s


__all__ = ["DBM", "dbm_to_watts", "RadioParams", "RadioChannel",
           "ICIParams", "ICIChannel"]
