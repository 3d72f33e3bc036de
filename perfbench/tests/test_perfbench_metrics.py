"""The metric arithmetic on small hand-worked inputs."""

from types import SimpleNamespace

import pytest

from perfbench import roofline, spec, stats, trace
from perfbench.reference import dlrm


def test_window_rate_and_tail():
    assert stats.rate(131072, 0.5) == 262144.0
    assert stats.intervals([1.0, 1.2, 1.5, 1.6]) == pytest.approx([0.2, 0.3, 0.1])
    xs = list(range(1, 22))  # 1..21: the 95th percentile sits at rank 19 of 0..20
    assert stats.percentile(xs, 95) == pytest.approx(20.0)
    assert stats.percentile([10.0, 20.0], 95) == pytest.approx(19.5)
    assert stats.percentile([4.0], 95) == 4.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_window_interval_tail_read_per_layer():
    read = spec.reader("window_interval_ms_p95")
    assert read(SimpleNamespace(window_intervals=[i / 1000 for i in range(1, 22)])) == pytest.approx(20.0)
    assert read(SimpleNamespace(window_intervals=[])) is None


def test_spread_is_the_quartile_distance_over_the_median():
    # quantiles(n=4) of 1..7 (exclusive method): 2, 4, 6
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx(1.0)


def _trace():
    dev = [("gather_rows_kernel(uint4 const*)", 0.0, 1.0),
           ("void chunk_kernel<8, __nv_bfloat16, SgdEpilogue<__nv_bfloat16> >", 0.5, 2.0),
           ("sm90_xmma_gemm_f32f32_tn", 4.0, 5.0),
           ("Memcpy HtoD (Pageable -> Device)", 7.0, 8.0),
           ("cudaStreamSynchronize", 8.0, 9.5)]  # a device-side wait: not work
    host = [("bench.plan_and_stage", 1.5, 7.5), ("aten::copy_", 2.5, 3.5), ("ProfilerStep#3", 0.0, 10.0)]
    return trace.Trace(device=[d for d in dev if "Synchronize" not in d[0]], host=host, spans=host[:1])


def test_idle_share_from_a_hand_made_trace():
    t = _trace()
    # busy: [0, 2] + [4, 5] + [7, 8] = 4 s of the window [0, 10]
    assert trace.busy_seconds(t) == pytest.approx(4.0)
    assert trace.window(t) == (0.0, 10.0)
    assert trace.idle_share(t) == pytest.approx(0.6)
    assert trace.idle_share(trace.Trace([], t.host, t.spans)) is None


def test_kernel_time_by_name_and_breakdown():
    t = _trace()
    assert trace.kernel_time(t, "gather_rows") == (1, pytest.approx(1.0))
    assert trace.kernel_time(t, "binned_sgd") == (1, pytest.approx(1.5))
    assert trace.kernel_time(t, "gemm") == (1, pytest.approx(1.0))
    assert trace.steps_and_time(t, "ordered_scatter") == (0, 0.0)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["void chunk_kernel<8, __nv_bfloat16, SgdEpilogue<__nv_bfloat16> >", 1.5]
    # gaps: [2, 4] (host in bench.plan_and_stage / aten::copy_ at 3.0), [5, 7]
    assert b["idle_gaps"][0] == ["bench.plan_and_stage / aten::copy_", pytest.approx(2.0)]
    assert b["idle_gaps"][1][0] == "bench.plan_and_stage / ProfilerStep#3"


def test_kernel_names():
    assert roofline.kernel_of("_Z18gather_rows_kernelPK5uint4PKiPS_lll") == "gather_rows"
    assert roofline.kernel_of("void finish_kernel<8, float, SgdEpilogue<float> >(...)") == "binned_sgd"
    assert roofline.kernel_of("void chunk_kernel<8, float, ScatterEpilogue<Nothing> >(...)") is None
    assert roofline.kernel_of("void light_kernel<8, __nv_bfloat16, 0>(...)") == "ordered_scatter"
    assert roofline.kernel_of("ampere_sgemm_128x64_tn") == "gemm"
    assert roofline.kernel_of("nvjet_tss_256x128_64x4_1x2_h_bz_coopA_NNT") == "gemm"  # cuBLAS on Hopper
    # the port's own kernels win first, whatever else the name holds
    assert roofline.kernel_of("gather_rows_kernel<nvjet>") == "gather_rows"
    assert roofline.kernel_of("void light_kernel<8, cublas_gemm>") == "ordered_scatter"
    assert roofline.kernel_of("void at::native::vectorized_elementwise_kernel<4>") is None


def test_roofline_bytes():
    # L = 6 ids of which U = 4 distinct, D = 2, bf16 rows
    assert roofline.gather_rows_bytes(6, 4, 2, 2) == 6 * 4 + 4 * 2 * 2 + 6 * 2 * 2
    assert roofline.update_bytes(6, 4, 2, 2, 2) == 6 * 2 * 2 + 2 * 4 * 6 + 2 * 4 * 2 * 2
    assert roofline.memory_share(3.35e9, 2, 2e-3) == pytest.approx(100.0)


def _dlrm(tables, dim, dense_in, bottom, top):
    return {"num_embeddings_per_feature": [10] * tables, "embedding_dim": dim, "dense_in_features": dense_in,
            "dense_arch_layer_sizes": bottom, "over_arch_layer_sizes": top}


def test_step_flops():
    # a bottom layer 3 -> 4 whose input takes no gradient: 2 * 12 * 2; with a second
    # layer 4 -> 2: + 2 * 8 * 3; no tables: no dots; top (2 + 0) -> 1: 2 * 2 * 3
    assert dlrm.example_flops(_dlrm(0, 2, 3, [4, 2], [1])) == 48 + 2 * 8 * 3 + 2 * 2 * 3
    # 1 table of D = 2, 3 dense inputs: bottom 3 -> 2; n = 2 vectors, P = 1 pair;
    # top (2 + 1) -> 1
    assert dlrm.example_flops(_dlrm(1, 2, 3, [2], [1])) == 2 * 6 * 2 + 6 * 1 * 2 + 2 * 3 * 3
    # the Kaggle cell: 14,447,360 an example
    kaggle = dlrm.example_flops(spec.config("dlrm-criteo-kaggle-cached")["dlrm"])
    assert kaggle == 14_447_360
