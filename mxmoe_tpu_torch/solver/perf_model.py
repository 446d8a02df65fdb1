"""Kernel cost models for the MILP's runtime term (port of
``mxmoe_tpu/solver/perf_model.py``).

``PerfModel`` is the measured table (``trace.profiler``): per scheme, the
linear model ``t ~ first_iter_cost + inc x n_out_tiles`` of its kernel's
schedule, schema

    {scheme: {tile_repr: {"bm": int, "bn": int,
                          "first_iter_cost": ms, "inc": ms_per_tile}},
     "_meta": {...}}

``AnalyticPerfModel`` is the profile-free fallback, a roofline from the
H100's published peaks; ``OneLaunchPerfModel`` costs the mixed one-launch
step with effective rates fitted on the card (``solver.onelaunch_fit``).
Every rate here is the H100's: nothing measured on or for a TPU is a
default.
"""

from __future__ import annotations

import dataclasses
import json
import os

PERF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perf")
ONELAUNCH_JSON = os.path.join(PERF_DIR, "onelaunch_model.json")
TABLE_JSON = os.path.join(PERF_DIR, "performance_table.json")

# the H100's published peaks (SXM, dense, at 700 W): bf16 TFLOP/s, int8
# TOP/s, HBM GB/s (chip_smoke.py's PEAK_OPS_PER_S / HBM_BYTES_PER_S)
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0
H100_HBM_GBPS = 3350.0

# OneLaunchPerfModel's effective rates, fitted on "NVIDIA H100 80GB HBM3,
# 700.00 W" by ``python -m mxmoe_tpu_torch.solver.onelaunch_fit`` (the
# committed perf/onelaunch_model.json is that run, with its unpack rounds;
# the int8 rate is K4's on K2's wgmma body, 139.3 TOP/s on the 64 x 128
# mma.sync tile; the a16 rate is K6's on its wgmma body, 77.4 TFLOP/s on
# the 32 x 128 one)
H100_ONELAUNCH = {"int8_tflops_eff": 537.67, "bf16_tflops_eff": 313.78,
                  "hbm_gbps_eff": 1899.47, "quant_gbps_eff": 2735.26,
                  "unpack_gops": 29015.11, "launch_ms": 0.006850}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TileCost:
    bm: int
    bn: int
    first_iter_cost: float  # ms
    inc: float              # ms per output tile

    def problem_ms(self, m: int, n: int) -> float:
        return self.inc * _cdiv(max(m, 1), self.bm) * _cdiv(n, self.bn)


class PerfModel:
    """Measured performance table: per-scheme tile costs."""

    def __init__(self, table: dict[str, dict[str, TileCost]]):
        self.table = table

    def schemes(self) -> list[str]:
        return sorted(self.table)

    def best_tile(self, scheme: str, m: int, n: int) -> tuple[str, TileCost]:
        tiles = self.table[self._key(scheme)]
        return min(tiles.items(), key=lambda kv: kv[1].problem_ms(m, n))

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        return self.best_tile(scheme, m, n)[1].problem_ms(m, n)

    def bucket_tile(self, scheme: str, probs: list[tuple[int, int]]) -> tuple[str, TileCost]:
        """The tile of a scheme's bucket: argmin over its tiles of the sum of
        problem_ms over the bucket's actual (M, N) list."""
        tiles = self.table[self._key(scheme)]
        return min(tiles.items(),
                   key=lambda kv: sum(kv[1].problem_ms(m, n) for m, n in probs))

    def _key(self, scheme: str) -> str:
        if scheme in self.table:
            return scheme
        # a scheme family by prefix (w4a4_g-1_sym ...)
        for k in self.table:
            if scheme.startswith(k) or k.startswith(scheme):
                return k
        raise KeyError(f"scheme {scheme!r} not in perf table {list(self.table)}")

    def save(self, path: str, meta: dict | None = None) -> None:
        out = {s: {name: dataclasses.asdict(tc) for name, tc in tiles.items()}
               for s, tiles in self.table.items()}
        if meta is not None:
            out["_meta"] = meta
        with open(path, "w") as f:
            json.dump(out, f, indent=2)


def load_perf_table(path: str) -> PerfModel:
    with open(path) as f:
        raw = json.load(f)
    table = {}
    for scheme, tiles in raw.items():
        if not isinstance(tiles, dict):
            continue
        entry = {}
        for name, tc in tiles.items():
            if isinstance(tc, dict) and "inc" in tc:
                entry[name] = TileCost(
                    bm=int(tc.get("bm", 128)), bn=int(tc.get("bn", 256)),
                    first_iter_cost=float(tc.get("first_iter_cost", 0.0)),
                    inc=float(tc["inc"]))
        if entry:
            table[scheme] = entry
    return PerfModel(table)


def validate_analytic_against_measured(analytic: "AnalyticPerfModel",
                                       measured: PerfModel,
                                       shapes: list[tuple[int, int]] | None = None) -> dict:
    """Does the analytic roofline rank schemes as the measured table does?
    For every scheme pair of the table and every (M, N) shape, the cheaper
    scheme by each model -> {'agreement': fraction, 'pairs': n,
    'disagreements': [...]}."""
    shapes = shapes or [(310, 2816), (546, 2816), (810, 2816),
                        (8192, 11264), (546, 2048), (8192, 2048)]
    schemes = measured.schemes()
    agree = total = 0
    disagreements = []
    for i, a in enumerate(schemes):
        for b in schemes[i + 1:]:
            for m, n in shapes:
                am = analytic.problem_ms(a, m, n) < analytic.problem_ms(b, m, n)
                mm = measured.problem_ms(a, m, n) < measured.problem_ms(b, m, n)
                total += 1
                if am == mm:
                    agree += 1
                else:
                    disagreements.append({"schemes": (a, b), "shape": (m, n)})
    return {"agreement": agree / max(total, 1), "pairs": total,
            "disagreements": disagreements[:20]}


def _parse_bits(scheme: str) -> tuple[float, float, bool]:
    """(w_bits, a_bits, packed) of a scheme string; 16 / 16 for a name the
    grammar does not take."""
    from ..quant.schemes import parse_scheme

    packed = scheme.endswith("_packed")
    if packed:
        scheme = scheme[: -len("_packed")]
    try:
        c = parse_scheme(scheme)
    except ValueError:
        return 16.0, 16.0, packed
    return float(c.w_bits), float(c.a_bits), packed


class AnalyticPerfModel(PerfModel):
    """Roofline fallback. Per problem (scheme s, M x N output, K reduction):

      compute_ms = 2MNK / peak(s); memory_ms = bytes(s) / bw
      t = max(compute, memory) + 0.08 min(compute, memory)

    with the peaks the H100's published ones times ``efficiency``. The
    0.6 efficiency, the 0.08 overlap and the 1.10 packed-unpack factors
    were fitted on a TPU's measured table and are kept as they are; how
    well this model ranks schemes on the card is
    ``validate_analytic_against_measured`` against the H100 table, printed
    by ``chip_smoke.py``'s solve phase."""

    def __init__(self, k: int, peak_bf16_tflops: float = H100_BF16_TFLOPS,
                 peak_int8_tops: float = H100_INT8_TOPS,
                 hbm_gbps: float = H100_HBM_GBPS, efficiency: float = 0.6,
                 bm: int = 256, bn: int = 256):
        self.k = k
        self.peak_bf16 = peak_bf16_tflops * 1e12 * efficiency
        self.peak_int8 = peak_int8_tops * 1e12 * efficiency
        self.bw = hbm_gbps * 1e9 * efficiency
        self.bm, self.bn = bm, bn
        self.table = {}

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        wb, ab, packed = _parse_bits(scheme)
        k = self.k
        m = max(m, 1)
        flops = 2.0 * m * n * k
        peak = self.peak_int8 if (ab <= 8 and wb <= 8) else self.peak_bf16
        # sub-byte codes live in int8 unless nibble-packed
        w_bytes = n * k * (wb / 8.0 if packed else max(wb, 8) / 8.0)
        a_bytes = m * k * max(ab, 8) / 8.0 if ab < 16 else m * k * 2.0
        o_bytes = m * n * 2.0
        compute = flops / peak
        if packed:
            compute *= 1.10      # the nibble unpack on the critical path
        memory = (w_bytes + a_bytes + o_bytes) / self.bw
        return (max(compute, memory) + 0.08 * min(compute, memory)) * 1e3

    def best_tile(self, scheme: str, m: int, n: int):
        ms = self.problem_ms(scheme, m, n)
        tiles = _cdiv(max(m, 1), self.bm) * _cdiv(n, self.bn)
        return (f"analytic-bm{self.bm}-bn{self.bn}",
                TileCost(self.bm, self.bn, 0.0, ms / tiles))

    def bucket_tile(self, scheme: str, probs):
        # the roofline is tile-free: one analytic tile
        m = max(int(sum(p[0] for p in probs) / max(len(probs), 1)), 1)
        n = max(int(sum(p[1] for p in probs) / max(len(probs), 1)), 1)
        return self.best_tile(scheme, m, n)


class _SchemeCost:
    """A model and a scheme behind the TileCost.problem_ms protocol that
    ``bits_solver._cost_vectors``'s fixed point reads."""

    def __init__(self, model: "OneLaunchPerfModel", scheme: str):
        self.model, self.scheme = model, scheme
        self.bm, self.bn = 0, 0

    def problem_ms(self, m: int, n: int) -> float:
        return self.model.problem_ms(self.scheme, m, n)


class OneLaunchPerfModel(PerfModel):
    """Runtime of the mixed one-launch execution the port serves: every
    <= 8-bit w x a expert in ONE int8 launch (K1 act quant, then K4 over the
    ragged packed buffer), where a problem's compute does not depend on its
    bitwidth and the lever is the packed w <= 4 weight traffic; a16
    weight-only experts at the bf16 rate with bf16 activation reads.
    Per-problem cost, its additive share of the launch:

      w x a:  quant(m) + max(2mnk / int8_eff, (w_bytes + mk + 2mn) / bw)
              (+ nk / unpack for a packed expert)
      a16:    max(2mnk / bf16_eff, (w_bytes + 2mk + 2mn) / bw)

    with w_bytes = nk/2 for packed w <= 4 and nk otherwise. The defaults
    are the H100 fit (``H100_ONELAUNCH``); ``from_fit_json`` reads another
    (``solver.onelaunch_fit`` writes ``perf/onelaunch_model.json``)."""

    def __init__(self, k: int,
                 int8_tflops_eff: float = H100_ONELAUNCH["int8_tflops_eff"],
                 bf16_tflops_eff: float = H100_ONELAUNCH["bf16_tflops_eff"],
                 hbm_gbps_eff: float = H100_ONELAUNCH["hbm_gbps_eff"],
                 quant_gbps_eff: float = H100_ONELAUNCH["quant_gbps_eff"],
                 packed_w4: bool = True,
                 launch_ms: float = H100_ONELAUNCH["launch_ms"],
                 unpack_gops: float = H100_ONELAUNCH["unpack_gops"]):
        self.k = k
        self.int8 = int8_tflops_eff * 1e12
        self.bf16 = bf16_tflops_eff * 1e12
        self.bw = hbm_gbps_eff * 1e9
        self.qbw = quant_gbps_eff * 1e9
        self.packed_w4 = packed_w4
        # the nibble unpack of packed w <= 4 weights, additive at decode M
        # (0: no term)
        self.unpack = unpack_gops * 1e9
        # a launch's fixed cost: two GMM launches a MoE layer, a constant the
        # solver adds to a layer's time (it never moves the argmin)
        self.launch_ms = launch_ms
        self.table = {}

    @property
    def layer_const_ms(self) -> float:
        return 2.0 * self.launch_ms   # gate_up + down launches

    @classmethod
    def from_fit_json(cls, path: str, k: int, packed_w4: bool = True):
        with open(path) as f:
            fit = json.load(f)
        d = H100_ONELAUNCH
        return cls(k,
                   int8_tflops_eff=float(fit.get("int8_tflops_eff", d["int8_tflops_eff"])),
                   bf16_tflops_eff=float(fit.get("bf16_tflops_eff", d["bf16_tflops_eff"])),
                   hbm_gbps_eff=float(fit.get("hbm_gbps_eff", d["hbm_gbps_eff"])),
                   quant_gbps_eff=float(fit.get("quant_gbps_eff", d["quant_gbps_eff"])),
                   packed_w4=packed_w4,
                   launch_ms=float(fit.get("launch_ms", d["launch_ms"])),
                   unpack_gops=float(fit.get("unpack_gops", d["unpack_gops"])))

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        wb, ab, _ = _parse_bits(scheme)
        k = self.k
        m = max(m, 1)
        flops = 2.0 * m * n * k
        if ab <= 8 and wb <= 8:
            # one-launch int8 w x a: the storage is the only per-scheme lever
            packed = wb <= 4 and self.packed_w4
            w_bytes = n * k * (0.5 if packed else 1.0)
            # single-pass act quant: read bf16 once, write int8 codes
            quant = m * k * 3.0 / self.qbw
            gmm = max(flops / self.int8, (w_bytes + m * k + 2.0 * m * n) / self.bw)
            if packed and self.unpack > 0:
                gmm += n * k / self.unpack
            return (quant + gmm) * 1e3
        if ab >= 16 and wb < 16:
            # weight-only: the bf16 product on codes dequantized in the kernel
            w_bytes = n * k * (0.5 if wb <= 4 else 1.0)
            return max(flops / self.bf16,
                       (w_bytes + 2.0 * m * k + 2.0 * m * n) / self.bw) * 1e3
        # the bf16 scheme
        return max(flops / self.bf16,
                   (2.0 * n * k + 2.0 * m * k + 2.0 * m * n) / self.bw) * 1e3

    def best_tile(self, scheme: str, m: int, n: int):
        return ("onelaunch", _SchemeCost(self, scheme))

    def bucket_tile(self, scheme: str, probs):
        # every problem shares the one launch: the cost is additive and
        # tile-free, so the fixed point converges at once
        return ("onelaunch", _SchemeCost(self, scheme))
