"""The metric arithmetic on a synthetic trace, and the operation and byte
counts against hand counts at small shapes."""

import math

import numpy as np
import pytest

from vcbench.harness import cells, counts, trace

CFG = cells.load_json(f"{cells.ROOT}/vcbench/configs/tinyvc-fp32.json")
SERVING = cells.load_json(f"{cells.ROOT}/vcbench/configs/tinyvc-serving.json")


def ev(cat, name, ts, dur, corr=None):
    return dict(cat=cat, name=name, ts=ts, dur=dur, corr=corr)


def synthetic():
    """Two requests of 1 s each on the host; kernels launched inside the
    layer ranges, one launched outside any, device time overlapping."""
    e = [ev("user_annotation", "request", 0.0, 1.0), ev("user_annotation", "request", 1.5, 1.0),
         ev("user_annotation", "encoder", 0.1, 0.2), ev("user_annotation", "retrieval", 0.3, 0.1),
         ev("user_annotation", "decoder", 0.4, 0.5), ev("user_annotation", "unet", 0.6, 0.2),
         ev("user_annotation", "encoder", 1.6, 0.2)]
    launches = [(0.15, 1, "ln_kernel", 0.2, 0.1), (0.35, 2, "knn_topk_kernel", 0.4, 0.2),
                (0.45, 3, "osc_bank", 0.6, 0.05), (0.65, 4, "up_chain_f32", 0.65, 0.3),
                (1.2, 5, "elementwise", 1.2, 0.1), (1.65, 6, "ln_kernel", 1.7, 0.4)]
    for t, c, name, ks, kd in launches:
        e.append(ev("cuda_runtime", "cudaLaunchKernel", t, 0.01, c))
        e.append(ev("kernel", name, ks, kd, c))
    e.append(ev("cuda_runtime", "cudaMemcpyAsync", 0.95, 0.01, 7))
    e.append(ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 0.96, 0.02, 7))
    return trace.Trace(e, [(2, 61440), (2, 61440)], 4096, CFG)


def test_interval_union():
    total, merged = trace.union_s([(0, 2), (1, 3), (5, 6), (6, 7), (10, 10.5)])
    assert total == pytest.approx(5.5)
    assert merged == [(0, 3), (5, 7), (10, 10.5)]


def test_window_busy_idle_and_launches():
    t = synthetic()
    assert t.window == (0.0, 2.5) and t.window_s == pytest.approx(2.5)
    # kernels: [.2,.3] [.4,.6] [.6,.65] [.65,.95] [.96,.98] [1.2,1.3] [1.7,2.1]
    busy = 0.1 + 0.2 + 0.05 + 0.3 + 0.02 + 0.1 + 0.4
    assert t.busy_s() == pytest.approx(busy)
    assert cells.metric_reader("idle_share")(t) == pytest.approx(100 * (1 - busy / 2.5))
    assert t.launches() == 6
    assert cells.metric_reader("launches_per_request")(t) == pytest.approx(3.0)


def test_layer_device_time_by_launch_range():
    t = synthetic()
    assert t.range_device_s("encoder") == pytest.approx(0.1 + 0.4)
    assert cells.metric_reader("device_ms.encoder")(t) == pytest.approx(1e3 * 0.5 / 2)
    # decoder range holds the oscillator and the up chain; the U-Net's range the up chain
    assert cells.metric_reader("device_ms.source")(t) == pytest.approx(1e3 * 0.05 / 2)
    least = counts.least_s(t.layer_calls("retrieval"))
    assert cells.metric_reader("knn_roofline")(t) == pytest.approx(100 * least / 0.2)
    assert cells.metric_reader("unet_roofline")(t) == pytest.approx(
        100 * counts.least_s(t.layer_calls("unet")) / 0.3)
    peak = sum(counts.peak_s(t.layer_calls(layer))
               for layer in ("spectrogram", "encoder", "energy", "retrieval", "source", "unet"))
    assert cells.metric_reader("mfu")(t) == pytest.approx(100 * peak / 2.5)


def test_readers_return_nothing_without_device_work():
    t = trace.Trace([ev("user_annotation", "request", 0.0, 1.0)], [(1, 61440)], 4096, CFG)
    for name in ("launches_per_request", "device_ms.encoder", "knn_roofline", "device_ms.source",
                 "unet_roofline", "idle_share", "mfu"):
        assert cells.metric_reader(name)(t) is None


def test_breakdown_groups_and_idle_gaps():
    b = synthetic().breakdown()
    groups = dict(b["device_ops"])
    assert groups["kernel H (kNN)"] == pytest.approx(0.2)
    assert groups["kernel F (up chains)"] == pytest.approx(0.3)
    assert groups["device-to-host copies"] == pytest.approx(0.02)
    idle = dict(b["idle_gaps"])
    # gaps [0, .2] [.3, .4] [.95, .96] [.98, 1.2] [1.3, 1.7] [2.1, 2.5], split where the
    # host enters or leaves a range; between the requests for [1.0, 1.5]
    assert idle["between requests"] == pytest.approx(0.4)
    assert idle["request"] == pytest.approx(0.1 + 0.01 + 0.02 + 0.1 + 0.4)
    assert idle["encoder"] == pytest.approx(0.2) and idle["retrieval"] == pytest.approx(0.1)
    assert sum(idle.values()) == pytest.approx(2.5 - synthetic().busy_s())
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_p95_over_all_requests_and_rate_over_the_window():
    from vcbench import run

    lat = list(np.arange(1, 101) / 1000.0)  # 100 requests, 1..100 ms
    v = run.end_to_end(lat, 100 * 16 * 5.0, 12.5, 17.0)
    assert v["request_p95_ms"] == pytest.approx(95.05)
    assert v["audio_s_per_s"] == pytest.approx(640.0)
    assert v["setup_s"] == 17.0
    # one slow request among many moves the tail only as far as its rank
    v = run.end_to_end(lat[:-1] + [10.0], 1.0, 1.0, 0.0)
    assert v["request_p95_ms"] == pytest.approx(95.05)


def test_counts_by_hand():
    # kNN: R = 2*3 frames, N = 5 rows, C = 768
    (c,) = counts.knn(2, 3, 5, 768)
    assert c.flops == 2 * 6 * 5 * 768 and c.nbytes == 4 * (2 * 6 * 768 + 5 * 768)
    # spectrogram: 2 rows of 4 frames, n_fft 1920
    (s,) = counts.spectrogram(2, 4 * 480, 1920, 480)
    assert s.flops == pytest.approx(8 * (1920 + 2.5 * 1920 * math.log2(1920) + 4 * 961))
    # U-Net at B=1, F=2 frames (L = 960): the stem, a down chain and an up chain by hand
    u = counts.unet(1, 2, CFG["decoder"], 480)
    stem = u[2]
    assert stem.flops == 2 * 960 * 24 * 3 * 17 and stem.nbytes == 4 * (24 * 960 + 24 * 960)
    first_down = u[4]  # after the /5 decimation: T = 192, 24 -> 48
    assert first_down.flops == 2 * 192 * (6 * 24 * 24 + 4 * 24 * 48)
    last_up = u[-1]  # x5 to 960 samples, C = 24, the folded k=7 output conv in fp32
    assert last_up.flops == 960 * 32 * 24 * 24 and last_up.fp32_flops == 2 * 960 * 7 * 24
    assert last_up.peak == counts.FP32_FLOPS
    ub = counts.unet(1, 2, SERVING["decoder"], 480)[-1]
    assert ub.peak == counts.BF16_FLOPS and ub.fp32_flops == last_up.fp32_flops
    # a call's bound: bytes or operations, whichever is longer
    assert counts.Call(3.35e12, 0.0).bound_s() == pytest.approx(1.0)
    assert counts.Call(0.0, 67e12).bound_s() == pytest.approx(1.0)
    # encoder: the ssl stack's input 1x1 at R = 2 frames
    enc = counts.encoder(1, 2, CFG["encoder"], 961)
    assert enc[0].flops == 2 * 2 * 961 * 384
