"""Unit tests for utils/profiling.py on synthetic XSpace traces.

The summarizer's contract: sum the durations of events that carry an
``hlo_op`` stat on the requested platform's device plane, divide by
``steps``, key them by that HLO instruction (so a library call's several
kernels add up under one instruction), and map instruction names to
``op_name`` metadata parsed from compiled-HLO text.  A missing device
plane is an error, never a silent fallback to host threads.
"""

import jax
import jax.numpy as jnp
import pytest
from jax.profiler import ProfileData

from rangeclip.utils.profiling import (
    busy_ns,
    device_op_events,
    format_rows,
    op_names_from_hlo,
    summarize_trace,
)

HLO = """
HloModule jit_fn
%fusion.1 = f32[8]{0} fusion(...), kind=kLoop, op_name="jit(fn)/model/conv"
%fusion.2 = f32[8]{0} fusion(...), calls=%x, op_name="jit(fn)/model/topk"
"""


def _xspace(planes):
    """XSpace text proto: planes = [(name, [(line, [(kernel, start_ns,
    dur_ns, hlo_op or None)])])]; hlo_op is attached as a stat."""
    out, meta = [], {}
    for pid, (pname, lines) in enumerate(planes, 1):
        body, emeta = [], []
        for lid, (lname, events) in enumerate(lines, 1):
            evs = []
            for kernel, start, dur, op in events:
                mid = meta.setdefault((pid, kernel), len(meta) + 1)
                stat = (f' stats {{ metadata_id: 1 str_value: "{op}" }}'
                        if op else "")
                evs.append(f"events {{ metadata_id: {mid} "
                           f"offset_ps: {start * 1000} "
                           f"duration_ps: {dur * 1000}{stat} }}")
            body.append(f'lines {{ id: {lid} name: "{lname}" '
                        f'timestamp_ns: 0 {" ".join(evs)} }}')
        for (p, kernel), mid in meta.items():
            if p == pid:
                emeta.append(f'event_metadata {{ key: {mid} value {{ '
                             f'id: {mid} name: "{kernel}" }} }}')
        out.append(
            f'planes {{ id: {pid} name: "{pname}" {" ".join(body)} '
            f'{" ".join(emeta)} stat_metadata {{ key: 1 value {{ id: 1 '
            f'name: "hlo_op" }} }} }}')
    return ProfileData.from_text_proto("\n".join(out))


GPU_TRACE = [
    ("/host:CPU", [("python", [("fusion.1", 0, 9_999_000, "fusion.1")])]),
    ("/device:GPU:0", [
        ("Stream #13(Compute)", [
            # two steps of fusion.1; custom-call.2 launches two kernels
            ("loop_fusion", 0, 3_000_000, "fusion.1"),
            ("loop_fusion", 5_000_000, 1_000_000, "fusion.1"),
            ("sm90_gemm_a", 7_000_000, 300_000, "fusion.2"),
            ("sm90_gemm_b", 7_300_000, 200_000, "fusion.2"),
            # no hlo_op stat: a profiler marker, not an operation
            ("marker", 0, 50_000_000, None),
        ]),
    ]),
]


def test_summarize_trace_sums_device_track_and_maps_ops(tmp_path):
    rows = summarize_trace(None, steps=2, hlo_text=HLO,
                           profile=_xspace(GPU_TRACE))
    assert rows == [
        ("fusion.1", 2.0, "jit(fn)/model/conv"),
        ("fusion.2", 0.25, "jit(fn)/model/topk"),
    ]
    text = format_rows(rows, top=1)
    assert "device total: 2.25 ms/step" in text
    assert "fusion.1" in text and "fusion.2" not in text


def test_summarize_trace_cpu_backend_fallback(tmp_path):
    # The CPU backend is summarized only when asked for: its XLA executor
    # threads carry the hlo_op stat; a GPU request on a CPU-only trace
    # raises instead of silently summing host threads.
    trace = _xspace([("/host:CPU", [
        ("tf_XLAEigen", [("convolution.3", 0, 2_000_000, "convolution.3"),
                         ("ThunkExecutor::Execute", 0, 9_999_000, None)]),
    ])])
    rows = summarize_trace(None, steps=1, platform="cpu", profile=trace)
    assert rows == [("convolution.3", 2.0, "")]
    with pytest.raises(ValueError, match="no gpu device plane"):
        summarize_trace(None, profile=trace)


def test_device_busy_time_is_the_union_of_op_intervals():
    events = device_op_events(_xspace(GPU_TRACE), "gpu")
    assert len(events) == 4
    # [0,3) + [5,6) + [7,7.3) + [7.3,7.5) ms, overlaps counted once
    assert busy_ns(events) == pytest.approx(4_500_000)
    assert busy_ns([("a", 0, 10), ("b", 5, 10), ("c", 30, 1)]) == 16


def test_summarize_trace_reads_newest_xplane_file(tmp_path):
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    rows = summarize_trace(str(tmp_path), platform="cpu",
                           hlo_text=f.lower(x).compile().as_text())
    assert rows and all(ms >= 0 for _, ms, _ in rows)
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "empty"))


def test_op_names_from_hlo_first_definition_wins():
    mapping = op_names_from_hlo(HLO + HLO)  # duplicate defs
    assert mapping == {
        "fusion.1": "jit(fn)/model/conv",
        "fusion.2": "jit(fn)/model/topk",
    }


ROOFLINE_HLO = """
HloModule jit_step

%fused_computation.1 (p0: bf16[32,128,128,64], p1: bf16[3,3,64,64]) -> bf16[32,128,128,64] {
  %p0 = bf16[32,128,128,64]{3,2,1,0} parameter(0)
  %p1 = bf16[3,3,64,64]{3,2,1,0} parameter(1)
  %conv.1 = bf16[32,128,128,64]{3,2,1,0} convolution(bf16[32,128,128,64]{3,2,1,0} %p0, bf16[3,3,64,64]{3,2,1,0} %p1), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f
  ROOT %r = bf16[32,128,128,64]{3,2,1,0} add(bf16[32,128,128,64]{3,2,1,0} %conv.1, bf16[32,128,128,64]{3,2,1,0} %p0)
}

ENTRY %main (a: bf16[32,128,128,64], k: bf16[3,3,64,64], x: f32[1024,512], y: f32[512,256]) -> f32[1024,256] {
  %a = bf16[32,128,128,64]{3,2,1,0} parameter(0)
  %k = bf16[3,3,64,64]{3,2,1,0} parameter(1)
  %fusion.9 = bf16[32,128,128,64]{3,2,1,0} fusion(bf16[32,128,128,64]{3,2,1,0} %a, bf16[3,3,64,64]{3,2,1,0} %k), kind=kOutput, calls=%fused_computation.1, metadata={op_name="jit(step)/model/conv"}
  %x = f32[1024,512]{1,0} parameter(2)
  %y = f32[512,256]{1,0} parameter(3)
  ROOT %dot.7 = f32[1024,256]{1,0} dot(f32[1024,512]{1,0} %x, f32[512,256]{1,0} %y), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(step)/model/proj"}
}
"""


def test_parse_hlo_instructions_bytes_and_flops():
    from rangeclip.utils.roofline import parse_hlo_instructions

    instrs = parse_hlo_instructions(ROOFLINE_HLO)
    # fusion: bytes = result + 2 operands (bf16), flops = conv inside the
    # called computation: 2 * out_elems * Cin * 3*3
    fusion = instrs["fusion.9"]
    conv_flops = 2 * (32 * 128 * 128 * 64) * 64 * 9
    assert fusion["flops"] == conv_flops
    buf = 32 * 128 * 128 * 64 * 2
    assert fusion["bytes"] == 2 * buf + 3 * 3 * 64 * 64 * 2
    assert fusion["op"] == "jit(step)/model/conv"
    # plain dot: 2 * M*N*K
    dot = instrs["dot.7"]
    assert dot["flops"] == 2 * 1024 * 256 * 512
    assert dot["bytes"] == 4 * (1024 * 256 + 1024 * 512 + 512 * 256)


def test_roofline_rows_and_buckets():
    from rangeclip.utils.roofline import (
        bucket_rows,
        format_interval_table,
        parse_hlo_instructions,
        roofline_rows,
    )

    instrs = parse_hlo_instructions(ROOFLINE_HLO)
    trace = [("fusion.9", 2.0, "jit(step)/model/conv"),
             ("dot.7", 1.0, "jit(step)/model/proj"),
             ("custom-call.3", 5.0, "jit(step)/loss/ce")]
    rows = roofline_rows(trace, instrs, peak_flops=100e12, peak_bytes=800e9,
                         kernel_flops={"loss/ce": 3.0e12})
    by_name = {r["instr"]: r for r in rows}
    # the custom-call got its analytic FLOPs from the table
    ce = by_name["custom-call.3"]
    assert ce["gflop"] == 3000.0
    assert ce["bound"] == "flop"
    # 3e12 flops / 100e12 peak = 30 ms bound vs 5 ms measured -> >100%
    assert ce["attainment"] == pytest.approx(6.0)
    conv = by_name["fusion.9"]
    assert conv["bound"] == "flop"  # 12.9 GFLOP vs 0.13 GB at these peaks
    assert 0 < conv["attainment"] < 1.5

    buckets = bucket_rows(rows, [("convs", r"model/conv"),
                                 ("ce", r"loss/ce")])
    names = [b["interval"] for b in buckets]
    assert names == ["convs", "ce", "other"]
    table = format_interval_table(buckets, total_ms=8.0)
    assert "| convs |" in table and "| ce |" in table


def _conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("case, want", [
    # 2 x output elements x (Cin x window)
    ("conv", 2 * (2 * 8 * 8 * 16) * 4 * 9),
    ("grouped_conv", 2 * (2 * 8 * 8 * 16) * 2 * 9),
    ("dot", 2 * 5 * 7 * 6),
    ("scan", 3 * 2 * 5 * 6 * 6),
    ("nested_jit", 2 * 5 * 7 * 6),
])
def test_jaxpr_matmul_flops_counts_from_shapes(case, want):
    from rangeclip.utils.roofline import jaxpr_matmul_flops

    x = jnp.ones((2, 8, 8, 4))
    a, b = jnp.ones((5, 6)), jnp.ones((6, 7))
    sq = jnp.ones((6, 6))
    fns = {
        "conv": lambda: _conv(x, jnp.ones((3, 3, 4, 16))),
        "grouped_conv": lambda: jax.lax.conv_general_dilated(
            x, jnp.ones((3, 3, 2, 16)), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=2),
        "dot": lambda: a @ b,
        "scan": lambda: jax.lax.scan(lambda c, _: (c @ sq, None), a, None,
                                     length=3)[0],
        "nested_jit": lambda: jax.jit(lambda u: jax.jit(jnp.matmul)(u, b))(a),
    }
    assert jaxpr_matmul_flops(jax.make_jaxpr(fns[case])()) == want
