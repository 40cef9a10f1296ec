"""Per-instruction roofline attribution from compiled-HLO text + a device
trace.

The step-level ledger (cli/benchmark.py train mode) reports one FLOP count
and one byte count for the whole program — honest, but it cannot say WHICH
part of a 60 ms step is near ITS own bound.  This module closes that gap:

  * :func:`parse_hlo_instructions` statically parses the compiled HLO text
    into per-instruction records: result+operand buffer bytes (the
    analytic minimum HBM traffic of that instruction: every operand read
    once + result written once) and matmul FLOPs (convolution / dot
    sub-instructions inside each fusion's called computation; elementwise
    flops are ignored — they rarely bind against the matmul/HBM rooflines).
    Compiled HLO may print operands as bare ``%name`` references, so the
    parse is two-pass: first map every instruction name to its RESULT
    buffer bytes/shape, then resolve each line's operand list against
    that map.
  * :func:`roofline_rows` joins those records with
    ``profiling.summarize_trace`` durations and computes, per instruction:
    achieved GB/s, achieved TFLOP/s, and the binding-roofline attainment
    ``max(t_flop, t_byte) / t_actual`` where ``t_flop = flops/peak_flops``
    and ``t_byte = bytes/peak_bw``.
  * :func:`bucket_rows` groups instructions into model-level intervals
    (encoder, decoder, CE, TV, ...) via op_name/instruction
    patterns, so a table has ~8 rows instead of ~300.
  * :func:`jaxpr_matmul_flops` counts a program's convolution and dot
    FLOPs from its jaxpr, before XLA rewrites anything: on the GPU the
    convolutions become cuDNN custom calls that neither the HLO text nor
    XLA's ``cost_analysis`` counts.

Caveats (kept in the printed table footer): bytes are the analytic
minimum (fusions that re-read an operand, or spill, move more — attainment
can exceed 100% on nothing-to-move fusions and underestimate true
efficiency elsewhere); custom-call FLOPs are supplied by the caller
per kernel (the HLO text does not describe the kernel body); elementwise-
bound kernels (softmax rows, selection networks) legitimately show low
matmul/HBM attainment — their bound is neither roofline.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_REF_RE = re.compile(r"%([\w.\-]+)")


def _dims(dimstr: str) -> List[int]:
    return [int(d) for d in dimstr.split(",") if d]


def _split_line(line: str) -> Tuple[str, str]:
    """(result segment, operand segment) of an instruction line.

    The result type(s) sit between ``= `` and the opcode call; operands
    are inside the call parens.  Works for both HLO prints: jax.export
    style (operands carry inline types) and compiled style (operands
    are bare %refs with layout-annotated result types)."""
    _, _, rhs = line.partition(" = ")
    rhs = re.sub(r"calls=%[\w.\-]+", "", rhs)
    rhs = rhs.split("metadata=")[0]
    m = re.search(r"[\w\-]+\(", rhs)
    if not m:
        return rhs, ""
    return rhs[: m.start()], rhs[m.end() - 1:]


def _shapes_bytes(segment: str) -> int:
    return sum(
        math.prod(_dims(s)) * _DTYPE_BYTES[d]
        for d, s in _SHAPE_RE.findall(segment)
    )


def _result_bytes(line: str) -> int:
    """Buffer bytes of the instruction's RESULT (tuple results sum
    members)."""
    res_seg, _ = _split_line(line)
    return _shapes_bytes(res_seg)


def _operands(line: str) -> List[str]:
    """Operand instruction names referenced by a line (in order)."""
    _, op_seg = _split_line(line)
    return _REF_RE.findall(op_seg)


def _operand_bytes(line: str, res_bytes: Dict[str, int]) -> int:
    """Bytes read by the operands: inline types when printed (jax.export
    HLO), else resolved against the definition map (compiled HLO)."""
    _, op_seg = _split_line(line)
    inline = _shapes_bytes(op_seg)
    if inline:
        return inline
    return sum(res_bytes.get(op, 0) for op in _REF_RE.findall(op_seg))


def _conv_flops(line: str, out_dims: List[int],
                rhs_shape: Optional[List[int]]) -> Optional[int]:
    """2 * out_elems * Cin_per_group * prod(window)."""
    m = re.search(r"dim_labels=([\w?]+)_([\w?]+)->([\w?]+)", line)
    win = re.search(r"window={[^}]*size=([\dx]+)", line)
    if not m or not win or not out_dims or not rhs_shape:
        return None
    rhs_labels = m.group(2)
    try:
        cin = rhs_shape[rhs_labels.index("i")]
    except (ValueError, IndexError):
        return None
    groups = 1
    g = re.search(r"feature_group_count=(\d+)", line)
    if g:
        groups = int(g.group(1))
    window = math.prod(int(x) for x in win.group(1).split("x"))
    return 2 * math.prod(out_dims) * cin * window // max(groups, 1)


def _dot_flops(line: str, out_dims: List[int],
               lhs_shape: Optional[List[int]]) -> Optional[int]:
    """2 * out_elems * prod(lhs contracting dims)."""
    m = re.search(r"lhs_contracting_dims={([\d,]*)}", line)
    if not m or not out_dims or not lhs_shape:
        return None
    k = 1
    for i in m.group(1).split(","):
        if i:
            k *= lhs_shape[int(i)]
    return 2 * math.prod(out_dims) * k


def parse_hlo_instructions(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Parse compiled-HLO text into {instr_name: {bytes, flops, op}}.

    ``bytes`` = result + resolved operand buffers; ``flops`` sums
    convolution/dot FLOPs on the line itself or inside the fusion's
    called computation.
    """
    comp_re = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\([^)]*\)\s*->")

    # pass 1: (computation, name) -> (result bytes, first result shape).
    # Keying PER COMPUTATION matters: fused computations reuse local names
    # (%param_0, %p0 ...) and a global last-wins map can mis-resolve
    # operand shapes — wrong conv/dot FLOPs inside fusions.
    # HLO operands always reference values of the same computation.
    res_bytes: Dict[Tuple[str, str], int] = {}
    res_shape: Dict[Tuple[str, str], List[int]] = {}
    parsed: List[Tuple[str, str, str]] = []
    current = ""
    for ln in hlo_text.splitlines():
        cm = comp_re.match(ln)
        if cm:
            current = cm.group(1)
            continue
        if " = " not in ln:
            continue
        im = _INSTR_RE.match(ln)
        if not im:
            continue
        name = im.group(1)
        parsed.append((current, name, ln))
        res_bytes[(current, name)] = _result_bytes(ln)
        shp = _SHAPE_RE.search(ln)
        res_shape[(current, name)] = _dims(shp.group(2)) if shp else []

    # pass 2: per-line flops; accumulate per-computation flops for fusions
    comp_flops: Dict[str, int] = {}
    line_flops: Dict[Tuple[str, str], int] = {}
    for comp, name, ln in parsed:
        fl = None
        if "convolution(" in ln:
            ops = _operands(ln)
            rhs = res_shape.get((comp, ops[1])) if len(ops) > 1 else None
            fl = _conv_flops(ln, res_shape.get((comp, name), []), rhs)
        elif " dot(" in ln:
            ops = _operands(ln)
            lhs = res_shape.get((comp, ops[0])) if ops else None
            fl = _dot_flops(ln, res_shape.get((comp, name), []), lhs)
        if fl:
            line_flops[(comp, name)] = fl
            comp_flops[comp] = comp_flops.get(comp, 0) + fl

    by_comp: Dict[str, Dict[str, int]] = {}
    for (comp, name), b in res_bytes.items():
        by_comp.setdefault(comp, {})[name] = b

    out: Dict[str, Dict[str, float]] = {}
    for comp, name, ln in parsed:
        byt = res_bytes.get((comp, name), 0) \
            + _operand_bytes(ln, by_comp.get(comp, {}))
        fl = line_flops.get((comp, name), 0)
        if " fusion(" in ln:
            cm2 = _CALLS_RE.search(ln)
            if cm2:
                fl = comp_flops.get(cm2.group(1), 0)
        op = ""
        om = re.search(r"op_name=\"([^\"]+)\"", ln)
        if om:
            op = om.group(1)
        out[name] = {"bytes": float(byt), "flops": float(fl), "op": op}
    return out


def roofline_rows(
    trace_rows: List[Tuple[str, float, str]],
    instrs: Dict[str, Dict[str, float]],
    peak_flops: float,
    peak_bytes: float,
    kernel_flops: Optional[Dict[str, float]] = None,
) -> List[Dict]:
    """Join trace durations with per-instruction bytes/flops.

    kernel_flops: {substring-of-instr-or-op-name: flops} — analytic FLOP
    counts for custom-calls (HLO text cannot describe them); first
    match wins, insertion order preserved.
    """
    rows = []
    for name, ms, op in trace_rows:
        rec = instrs.get(name, {})
        byt = rec.get("bytes", 0.0)
        fl = rec.get("flops", 0.0)
        op = op or rec.get("op", "")
        if kernel_flops:
            for pat, kfl in kernel_flops.items():
                if pat in name or pat in op:
                    fl = max(fl, kfl)
                    break
        t = ms / 1e3
        t_fl = fl / peak_flops
        t_by = byt / peak_bytes
        bound = "flop" if t_fl >= t_by else "byte"
        attain = (max(t_fl, t_by) / t) if t > 0 else 0.0
        rows.append({
            "instr": name, "op": op, "ms": ms,
            "gb": byt / 1e9, "gflop": fl / 1e9,
            "gbps": byt / t / 1e9 if t > 0 else 0.0,
            "tflops": fl / t / 1e12 if t > 0 else 0.0,
            "bound": bound, "attainment": attain,
        })
    return rows


def bucket_rows(rows: List[Dict], buckets: List[Tuple[str, str]],
                ) -> List[Dict]:
    """Group rows into named intervals.  ``buckets`` is an ordered list of
    (bucket_name, regex) matched against ``op`` then ``instr``; first
    match wins; unmatched rows land in 'other'."""
    agg: Dict[str, Dict] = {}
    order = [b for b, _ in buckets] + ["other"]
    for r in rows:
        dest = "other"
        for bname, pat in buckets:
            if re.search(pat, r["op"]) or re.search(pat, r["instr"]):
                dest = bname
                break
        a = agg.setdefault(dest, {"interval": dest, "ms": 0.0, "gb": 0.0,
                                  "gflop": 0.0, "t_bound": 0.0,
                                  "n_instr": 0})
        a["ms"] += r["ms"]
        a["gb"] += r["gb"]
        a["gflop"] += r["gflop"]
        # binding time adds per instruction (each instruction binds on its
        # own better roofline: ms * attainment == max(t_flop, t_byte))
        a["t_bound"] += r["ms"] * r["attainment"]
        a["n_instr"] += 1
    out = []
    for name in order:
        if name not in agg:
            continue
        a = agg[name]
        t = a["ms"] / 1e3
        a["gbps"] = a["gb"] / t if t > 0 else 0.0
        a["tflops"] = a["gflop"] / 1e3 / t if t > 0 else 0.0
        a["attainment"] = a["t_bound"] / a["ms"] if a["ms"] > 0 else 0.0
        out.append(a)
    return out


def format_interval_table(buckets: List[Dict], total_ms: float) -> str:
    lines = [
        "| interval | ms/step | % step | GB | GB/s | GFLOP | TFLOP/s |"
        " % of own roofline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for b in buckets:
        lines.append(
            f"| {b['interval']} | {b['ms']:.2f} | "
            f"{100 * b['ms'] / total_ms:.0f}% | {b['gb']:.2f} | "
            f"{b['gbps']:.0f} | {b['gflop']:.0f} | {b['tflops']:.1f} | "
            f"{100 * b['attainment']:.0f}% |"
        )
    return "\n".join(lines)


def jaxpr_matmul_flops(jaxpr) -> int:
    """Convolution and dot FLOPs of a (closed) jaxpr, from the operand
    shapes: 2 x output elements x contraction size per
    ``conv_general_dilated`` / ``dot_general``, recursing into nested
    jaxprs (a ``scan`` body counts ``length`` times)."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec
            window = math.prod(rhs[d] for d in spec[2:])
            total += (2 * math.prod(eqn.outvars[0].aval.shape)
                      * rhs[spec[1]] * window)
        elif name == "dot_general":
            lhs = eqn.invars[0].aval.shape
            (contract, _), _ = eqn.params["dimension_numbers"]
            total += (2 * math.prod(eqn.outvars[0].aval.shape)
                      * math.prod(lhs[d] for d in contract))
        repeat = eqn.params.get("length", 1) if name == "scan" else 1
        for param in eqn.params.values():
            for sub in param if isinstance(param, (tuple, list)) else (param,):
                if hasattr(sub, "eqns") or hasattr(getattr(sub, "jaxpr", None),
                                                    "eqns"):
                    total += repeat * jaxpr_matmul_flops(sub)
    return total
