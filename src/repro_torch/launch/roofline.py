"""Roofline analysis from the compiled dry-run artifacts.

Three terms per (arch x shape), single-pod mesh, NVIDIA H100 SXM
constants (:class:`HW`; ``H100`` is the default everywhere):

    compute    = FLOPs / (chips * 989e12 bf16 FLOP/s)
    memory     = HBM bytes / (chips * 3.35e12 B/s)
    collective = collective bytes / (900e9 B/s of NVLink per card)

Sources and caveats:
  * The compute and memory terms come from exact *analytic* accounting
    (documented below), not from a compiler's cost model, which counts a
    loop body once and so under-counts scanned layers and
    gradient-accumulation loops; the compiled program's FLOPs are
    reported alongside.
  * Collective bytes are parsed from an optimized XLA HLO text dump with
    **trip-count correction**: each collective inside a while body is
    multiplied by the product of enclosing loop trip counts (recovered
    from the loop condition's comparison constant).
  * MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); the ratio
    MODEL_FLOPS / analytic FLOPs (with the remat pass) exposes
    remat/attention overhead.

The arithmetic is the reference package's (``repro/launch/roofline.py``)
line for line; only the hardware constants differ.
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re

from ..configs import config_for_shape, get_config, get_shape
from ..configs.base import ModelConfig
from ..configs.shapes import InputShape

__all__ = ["HW", "H100", "analytic_flops", "analytic_bytes",
           "corrected_collectives", "analyze_record", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun")


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM per-card constants (the H100 SXM data sheet).
    ``ici_bw`` keeps the reference's field name for the card-to-card
    link: here NVLink 4."""

    peak_flops: float = 989e12       # bf16 FLOP/s, dense, tensor cores
    hbm_bw: float = 3.35e12          # B/s, HBM3
    # NVLink 4: 900 GB/s per card, counting both directions together
    # (450 GB/s each way), to all other cards of the host
    ici_bw: float = 900e9            # B/s per card
    hbm_bytes: float = 80e9          # bytes of HBM3


H100 = HW()


# --------------------------------------------------------------------------
# analytic FLOPs / bytes
# --------------------------------------------------------------------------

def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // (cfg.attn_every + 1)
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> dict:
    """Exact-order FLOPs accounting for one step of the shape's kind."""
    B, S = shape.global_batch, shape.seq_len
    N_act = cfg.active_params()
    Hq, hd = cfg.n_heads, cfg.hd
    L_attn = _attn_layer_count(cfg)

    if shape.kind == "train":
        D = B * S
        matmul_fwd = 2 * N_act * D
        eff_window = min(S, cfg.sliding_window) if cfg.sliding_window else S
        attn_fwd = 2 * B * S * eff_window * Hq * hd * L_attn  # causal ~1/2 *2ops*2flops
        fwd = matmul_fwd + attn_fwd
        total = 3 * fwd          # fwd + bwd(2x)
        remat_total = 4 * fwd    # + recompute pass
        model = 6 * N_act * D
        return {"fwd": fwd, "total": total, "with_remat": remat_total,
                "model_flops": model, "attn_fraction": attn_fwd / fwd}
    if shape.kind == "prefill":
        D = B * S
        eff_window = min(S, cfg.sliding_window) if cfg.sliding_window else S
        fwd = 2 * N_act * D + 2 * B * S * eff_window * Hq * hd * L_attn
        return {"fwd": fwd, "total": fwd, "with_remat": fwd,
                "model_flops": 2 * N_act * D,
                "attn_fraction": 1 - 2 * N_act * D / fwd}
    # decode: one token per request
    kv_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    matmul = 2 * N_act * B
    attn = 4 * B * Hq * hd * kv_len * L_attn
    ssm = 0
    if cfg.family in ("ssm", "hybrid"):
        n_ssm = cfg.n_layers - L_attn
        di = cfg.d_inner
        dk = cfg.ssm_state or (di // cfg.n_ssm_heads)
        dv = di // cfg.n_ssm_heads
        ssm = 6 * B * cfg.n_ssm_heads * dk * dv * n_ssm
    fwd = matmul + attn + ssm
    return {"fwd": fwd, "total": fwd, "with_remat": fwd,
            "model_flops": 2 * N_act * B,
            "attn_fraction": (attn + ssm) / fwd}


def _kv_cache_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    B, S = shape.global_batch, shape.seq_len
    L_attn = _attn_layer_count(cfg)
    kv_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv = 2 * L_attn * B * kv_len * cfg.n_kv_heads * cfg.hd * 2  # bf16
    if cfg.family in ("ssm", "hybrid"):
        n_ssm = cfg.n_layers - L_attn
        di = cfg.d_inner
        dk = cfg.ssm_state or (di // cfg.n_ssm_heads)
        kv += n_ssm * B * cfg.n_ssm_heads * dk * (di // cfg.n_ssm_heads) * 4
    if cfg.family == "audio":
        kv += 2 * cfg.n_layers * B * cfg.encoder_seq * cfg.n_kv_heads \
            * cfg.hd * 2
    return float(kv)


def analytic_bytes(cfg: ModelConfig, shape: InputShape) -> dict:
    """HBM traffic estimate for one step (the memory roofline term)."""
    B, S = shape.global_batch, shape.seq_len
    n_params = cfg.n_params()
    if shape.kind == "decode":
        # every decode step streams the full resident weights + KV once
        w = 2 * n_params                       # bf16 weights read
        kv = _kv_cache_bytes(cfg, shape)       # cache read (write is +B tok)
        return {"weights": w, "kv": kv, "activations": 0.0,
                "total": w + kv}
    # train / prefill: weights read (bf16), plus activations r/w; train adds
    # grad + optimizer traffic (fp32 m, v read+write, fp32 master rw)
    acts = 0.0
    d = cfg.d_model
    per_tok = 2 * d * 2 * max(cfg.n_layers, 1) * 4  # resid rd/wr few times
    acts = B * S * per_tok
    w = 2 * n_params
    if shape.kind == "train":
        opt = n_params * (4 + 4 + 4 + 4) * 2   # m,v,master,grad rw fp32
        return {"weights": 3 * w, "kv": 0.0, "activations": 3 * acts,
                "optimizer": opt, "total": 3 * w + 3 * acts + opt}
    return {"weights": w, "kv": 0.0, "activations": acts,
            "total": w + acts}


# --------------------------------------------------------------------------
# trip-count-corrected collective parsing
# --------------------------------------------------------------------------

_COMP_HDR = re.compile(r"^(?:ENTRY )?%?([\w.\-]+)\s*(?:\([^)]*\))?\s*->.*{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\),\s*condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_CALL_RE = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\S+))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(f32|f16|bf16|s32|u32|s8|u8|pred|f64|s64)"
                       r"\[([\d,]*)\]")
_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "s8": 1,
          "u8": 1, "pred": 1, "f64": 8, "s64": 8}


def _split_computations(text: str) -> dict[str, list[str]]:
    """Split optimized HLO text into computations.  A computation header is
    a column-0 line starting with '%name (' or 'ENTRY %name (' and ending
    with '{' (parameter lists may contain nested parens, so we only key on
    the leading token)."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            head = line.split("(", 1)[0].strip()
            if head.startswith("ENTRY"):
                head = head[len("ENTRY"):].strip()
            name = head.lstrip("%").strip()
            if name:
                cur = name
                comps[cur] = []
                continue
        if cur is not None:
            comps[cur].append(line)
            if line.strip() == "}":
                cur = None
    return comps


def _shape_bytes(s: str) -> int:
    tot = 0
    for t, dims in _SHAPE_RE.findall(s):
        n = 1
        for dstr in dims.split(","):
            if dstr:
                n *= int(dstr)
        tot += n * _BYTES[t]
    return tot


def corrected_collectives(text: str) -> dict:
    """Collective bytes with while-loop trip-count multiplication."""
    comps = _split_computations(text)

    def trip_count(cond_name: str) -> int:
        lines = comps.get(cond_name, [])
        consts = [int(c) for ln in lines for c in _CONST_RE.findall(ln)]
        consts = [c for c in consts if c > 1]
        return max(consts) if consts else 1

    def walk(name: str, seen: tuple) -> dict:
        """bytes-by-op of computation ``name`` including nested calls."""
        if name in seen or name not in comps:
            return {}
        out: dict[str, float] = {}
        for ln in comps[name]:
            mw = _WHILE_RE.search(ln)
            if mw:
                tc = trip_count(mw.group(1))
                sub = walk(mw.group(2), seen + (name,))
                for k, v in sub.items():
                    out[k] = out.get(k, 0) + v * tc
                continue
            mcoll = _COLL_RE.search(ln)
            if mcoll:
                out[mcoll.group(2)] = out.get(mcoll.group(2), 0) \
                    + _shape_bytes(mcoll.group(1))
                continue
            for cal in _CALL_RE.findall(ln):
                sub = walk(cal, seen + (name,))
                for k, v in sub.items():
                    out[k] = out.get(k, 0) + v
        return out

    entry = None
    for name in comps:
        if "main" in name or entry is None:
            entry = name if "main" in name else entry
    if entry is None:
        # fall back: the computation that contains while/collectives most
        entry = max(comps, key=lambda n: len(comps[n]))
    by_op = walk(entry, ())
    return {"bytes_by_op": by_op, "total_bytes": sum(by_op.values())}


# --------------------------------------------------------------------------
# per-record analysis
# --------------------------------------------------------------------------

def analyze_record(rec: dict, hw: HW = H100) -> dict:
    """Derive the three roofline terms (seconds) for one dry-run record."""
    arch, shape_name = rec["arch"], rec["shape"]
    shape = get_shape(shape_name)
    cfg = config_for_shape(get_config(arch), shape)
    chips = rec["chips"]

    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape)
    coll = rec.get("collectives_corrected") or rec.get("collectives") or {}
    coll_bytes = coll.get("total_bytes", 0.0)

    t_compute = fl["with_remat"] / (chips * hw.peak_flops)
    t_memory = by["total"] / (chips * hw.hbm_bw)
    # collective bytes in the HLO are per-device program traffic, over
    # the card's one NVLink rate
    t_coll = coll_bytes / hw.ici_bw

    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    hlo_flops = rec.get("cost", {}).get("flops", 0.0)
    out = {
        "arch": arch, "shape": shape_name, "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": fl["model_flops"],
        "analytic_flops": fl["with_remat"],
        "useful_ratio": fl["model_flops"] / max(fl["with_remat"], 1.0),
        "hlo_flops_per_device": hlo_flops,
        "collective_bytes": coll_bytes,
        "attn_fraction": fl["attn_fraction"],
        "mem_breakdown": by,
        "ok": rec.get("ok", False),
    }
    # one sentence on what moves the dominant term down
    tips = {
        "compute": "reduce recompute (remat policy) or shard more of the "
                   "per-chip FLOPs (bigger model axis / better MoE EP)",
        "memory": "cut resident-weight restreams (wider batching amortizes "
                  "weight reads) or shrink the KV footprint (window/GQA)",
        "collective": "overlap or shrink collectives: reduce-scatter "
                      "instead of all-reduce, bf16 collectives, fewer "
                      "psum points per layer",
    }
    out["tip"] = tips[dominant]
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = []
    for path in sorted(glob.glob(os.path.join(args.dir,
                                              f"*__{args.mesh}.json"))):
        rec = json.load(open(path))
        gz = path.replace(".json", ".hlo.gz")
        if os.path.exists(gz) and "collectives_corrected" not in rec:
            text = gzip.open(gz, "rt").read()
            rec["collectives_corrected"] = corrected_collectives(text)
        rows.append(analyze_record(rec))

    hdr = (f"{'arch':24s} {'shape':12s} {'comp(ms)':>9s} {'mem(ms)':>9s} "
           f"{'coll(ms)':>9s} {'dominant':>10s} {'useful':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} "
              f"{r['t_compute_s']*1e3:9.3f} {r['t_memory_s']*1e3:9.3f} "
              f"{r['t_collective_s']*1e3:9.3f} {r['dominant']:>10s} "
              f"{r['useful_ratio']:7.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
