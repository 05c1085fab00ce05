"""The work reckoning against hand arithmetic, and the trace reduction
(busy time, idle gaps, the launch-count cross-check) on a planted event
list."""
import pytest

from perfbench import spec, trace, work

PHI4 = spec.as_run(spec.load_json(spec.ROOT / "perfbench/configs/phi4-mini.json"))
MIXTRAL = spec.as_run(
    spec.load_json(spec.ROOT / "perfbench/configs/mixtral-8x22b.json"))


def test_phi4_param_count():
    # embed 200,064 x 3,072 = 614,596,608; a layer: 2 norms 6,144, wq and
    # wo 2 x 9,437,184, wk and wv 2 x 3,145,728, MLP 3 x 25,165,824, so
    # 100,669,440; 32 layers 3,221,422,080; the final norm 3,072.
    assert work.param_count(PHI4) == 3_836_021_760


def test_phi4_layer_at_2048_tokens():
    # Flops: 2 T (D H hd + 2 D Hkv hd + H hd D + 3 D F)
    #      = 2 x 2048 x (9,437,184 + 6,291,456 + 9,437,184 + 75,497,472).
    # Bytes (bf16, A and B read, C written, the gate and two residuals):
    # wq 44,040,192; wk, wv 23,068,672 each; wo 56,623,104; wu 96,468,992;
    # wg 130,023,424; wd 109,051,904.
    fwd = work.attn_gemms(PHI4, 2048, fused_residual=True) \
        + work.ffn_gemms(PHI4, 2048)
    assert sum(f for f, _ in fwd) == 412_316_860_416
    assert sum(b for _, b in fwd) == 482_344_960


def test_mixtral_moe_layer_at_4096_tokens():
    # 8,192 routed rows; each expert product 2 x 8192 x 16384 x 6144 flops;
    # wu reads 8192 x 6144 rows and 8 experts' 6144 x 16384 weights and
    # writes 8192 x 16384: 2 x 989,855,744 bytes; wg reads the gate too;
    # wd mirrors wu.
    wu, wg, wd = work.ffn_gemms(MIXTRAL, 4096)
    assert wu[0] == wg[0] == wd[0] == 1_649_267_441_664
    assert wu[1] == wd[1] == 1_979_711_488
    assert wg[1] == 2_248_146_944


def test_causal_attention_call():
    # pairs 8192 x 8193 / 2 = 33,558,528; flops 4 x 48 x pairs x 128;
    # bytes q and o 2 x 48 x 8192 x 128, k and v 2 x 8 x 8192 x 128, bf16.
    f, b = work.attention_fwd(1, 48, 8, 8192, 128)
    assert f == 824_734_384_128
    assert b == 234_881_024


def test_decode_least_bytes():
    # Every weight once but the embedding table, each row's embedding,
    # keys and values 0..pos read and the new ones written.
    n = work.param_count(MIXTRAL) - 32768 * 6144
    got = work.decode_step_least_bytes(MIXTRAL, [100, 200])
    kv = 2 * 8 * 8 * 128 * 2 * (102 + 202)
    assert got == 2 * n + 2 * 6144 * 2 + kv


def _planted():
    # Device busy [100, 300], [350, 450], [500, 550], [600, 700] µs in a
    # 1,000 µs window; host "outer" spans it all, "inner" [700, 1000].
    ev = [{"name": trace.WINDOW, "cat": "user_annotation", "ts": 0,
           "dur": 1000},
          {"name": "void gemm_dense_sm90<2>(...)", "cat": "kernel",
           "ts": 100, "dur": 200},
          {"name": "void gemm_grouped_sm90<1>(...)", "cat": "kernel",
           "ts": 350, "dur": 100},
          {"name": "void flash_fwd_kernel<2, 64>(...)", "cat": "kernel",
           "ts": 500, "dur": 50},
          {"name": "elementwise", "cat": "kernel", "ts": 600, "dur": 100},
          {"name": "outer", "cat": "cpu_op", "ts": 0, "dur": 1000},
          {"name": "inner", "cat": "cpu_op", "ts": 700, "dur": 300}]
    return ev


def test_trace_reduction_on_planted_events():
    s = trace.summarize(_planted(), trace.kernel_classes())
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["class_n"] == {"gemm": 2, "flash": 1}
    assert s["class_s"]["gemm"] == pytest.approx(300e-6)
    assert s["class_s"]["flash"] == pytest.approx(50e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["inner"] == pytest.approx(300e-6)
    assert gaps["outer"] == pytest.approx(250e-6)
    assert s["device_ops"][0][0].startswith("void gemm_dense_sm90")


def test_launch_cross_check():
    s = trace.summarize(_planted(), trace.kernel_classes())
    s["work_s"] = {"gemm": 150e-6, "flash": 10e-6}
    s["launches"] = {"gemm": 2, "flash": 1}
    ctx = {"trace": s}
    assert trace.roofline_share(ctx, "gemm") == pytest.approx(50.0)
    assert trace.roofline_share(ctx, "flash") == pytest.approx(20.0)
    assert trace.idle_share(ctx) == pytest.approx(55.0)
    # One launch more than the trace holds: a dropped event, not measured.
    s["launches"] = {"gemm": 3, "flash": 1}
    assert trace.roofline_share(ctx, "gemm") is None
    assert trace.roofline_share(ctx, "flash") == pytest.approx(20.0)
