"""The yardstick's arithmetic: model FLOPs, kernel bounds at the kernel
table's shapes, percentiles and rates over a window, device timelines."""

import statistics

import pytest

from cebench.lib import yardstick as y


def test_bert_base_model_flops():
    assert y.encoder_weights(768, 12, 3072) == 84_934_656
    assert y.seq_flops(768, 12, 3072, 256) / 1e9 == pytest.approx(45.9, abs=0.05)
    assert y.seq_flops(768, 12, 3072, 128) / 1e9 == pytest.approx(22.3, abs=0.05)


@pytest.mark.parametrize(
    "b, g, s, bound_ms",
    [
        # PERF.md's kernel table, every key valid: towers' hard negatives and labels
        (252, 128, 128, 0.0592), (252, 1, 128, 0.0298), (256, 128, 128, 0.0601), (256, 1, 128, 0.0303),
        (4, 128, 128, 0.0009), (4, 1, 128, 0.0005),
    ],
)
def test_attention_bound_at_the_kernel_tables_shapes(b, g, s, bound_ms):
    nbytes, ops = y.attention_cost(b, g, s, 12, 64, b * s, 2)
    assert y.bound_s(nbytes, ops) * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    assert nbytes / y.HBM_BYTES_PER_S > ops / y.PEAK_OPS["bf16"]  # bound by bytes


def test_attention_counts_valid_keys_only():
    full = y.attention_cost(8, 256, 256, 12, 64, 8 * 256, 2)
    half = y.attention_cost(8, 256, 256, 12, 64, 8 * 128, 2)
    assert half[1] == full[1] / 2
    assert half[0] < full[0]


def test_mips_bound_at_the_kernel_tables_shape():
    # q=32 d=500 n_valid=10000 k=100: 0.0060 ms, bound by bytes
    nbytes, ops = y.mips_cost(32, 500, 10000, 100, 0)
    assert y.bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0060, abs=5e-5)
    # operations counted once at the bf16 peak: 2 q n d
    assert ops == 2 * 32 * 10000 * 500
    # exclusion lists are read
    assert y.mips_cost(32, 500, 10000, 100, 184)[0] - nbytes == 8 * 32 * 184


def test_percentile_matches_linear_interpolation():
    xs = list(range(1, 101))
    assert y.percentile(xs, 95) == pytest.approx(95.05)
    assert y.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        y.percentile([], 95)


def test_tail_over_a_timeline_with_a_stall():
    # 200 requests at 10 ms, then a stall: every request due in the
    # stall's 2 s waits for its end, so the tail is the stall's
    due = [i * 0.05 for i in range(400)]
    done = [t + 0.01 for t in due]
    for i, t in enumerate(due):
        if 10.0 <= t < 12.0:
            done[i] = 12.0 + 0.01
    lat = [d - t for d, t in zip(done, due)]
    assert y.percentile(lat, 50) == pytest.approx(0.01)
    assert y.percentile(lat, 95) > 1.0


def test_rate_over_window_counts_whole_units_to_the_last_end():
    units = [(0.0, 1.0, 100), (1.0, 2.0, 100), (2.0, 3.5, 100), (9.9, 12.0, 100), (12.5, 13.0, 100)]
    # the unit started before the 10 s deadline counts whole; time runs to its end
    assert y.rate_over_window(units, 0.0, 10.0) == pytest.approx(400 / 12.0)
    # a stall inside the window lowers the rate: no median of chunks hides it
    assert y.rate_over_window(units[:3], 0.0, 10.0) == pytest.approx(300 / 3.5)
    assert y.rate_over_window([], 0.0, 10.0) is None


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 10.2, 9.9, 10.1, 10.0, 10.3]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert y.spread(vals) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps_of_device_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7)]
    assert y.union_seconds(iv) == pytest.approx(5.0)
    assert y.gaps(iv, 0, 10) == [(3, 5), (7, 10)]
    assert y.gaps([], 0, 1) == [(0, 1)]


@pytest.mark.parametrize(
    "name, group",
    [
        ("void hopper::attention_fwd_wgmma_kernel<64>(Params)", "kernel_A_attention"),
        ("tc::mips_score_tc_kernel(...)", "kernel_B_mips_topk"),
        ("mips_select_kernel", "kernel_B_mips_topk"),
        ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", "matmul"),
        ("void at::native::vectorized_layer_norm_kernel<float, float, false>", "other"),
        ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ],
)
def test_kernel_groups(name, group):
    assert y.group_kernel(name) == group


class _Trace:
    """A device trace with ``n`` kernels of one group, 1 ms each."""

    def __init__(self, n):
        self.n = n

    def group_seconds(self, group):
        return self.n * 1e-3

    def count(self, group):
        return self.n


def test_roofline_scales_only_for_dropped_records():
    from cebench.lib.roofline import share

    costs = [(1e-3 * y.HBM_BYTES_PER_S / 2, 0.0)] * 4  # four launches, 0.5 ms bound each
    assert share(costs, "g", _Trace(4), kernels_per_launch=1) == pytest.approx(50.0)
    # the profiler kept three of four kernels: three launches' bounds over their time
    assert share(costs, "g", _Trace(3), kernels_per_launch=1) == pytest.approx(50.0)
    # more kernels than launches: miscounted, no share
    assert share(costs, "g", _Trace(8), kernels_per_launch=1) is None
    assert share(costs, "g", None) is None and share([], "g", _Trace(4)) is None


@pytest.mark.parametrize("closed", [True, False])
def test_model_work_leaves_out_the_profiled_sub_window(closed):
    from cebench.lib.harness import Run

    run = Run("ce-yugioh.build", 1, 10.0, False, "cpu")
    run.window_start = 100.0
    # four units of 2 s (1 FLOP each) back to back, one inside the sub-window
    # whose profiler start and stop took 1 s more
    units = [(100.0, 102.0, 1.0), (102.0, 104.0, 1.0), (104.5, 106.5, 1.0), (107.5, 109.5, 1.0)]
    run.model_work(units, closed)
    assert run.counters["model_flop"] == 4
    assert run.counters["model_seconds"] == pytest.approx(9.5 if closed else 8.0)
    run.traced_span = (104.0, 107.5)
    run.model_work(units, closed)
    assert run.counters["model_flop"] == 3
    assert run.counters["model_seconds"] == pytest.approx(6.0)
