"""The trace's reduction: the union of device intervals, idle gaps by the
host operation running at their middle, launches a step and lost records,
a shared helper kernel attributed to the op whose main kernel follows it."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from perfbench import trace


def _event(name, start, end, device=True, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


def _two_steps():
    events = []
    for step in (0, 100):
        events += [
            _event("void pad_planes_kernel<float>(float*)", step + 0, step + 5),
            _event("conv3x3_stats_tf32_kernel<64>", step + 5, step + 25),
            _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", step + 20, step + 40),
            _event("nccl:all_reduce", step + 15, step + 45, annotation=True),
            _event("pad_planes_kernel<float>", step + 60, step + 62),
            _event("filter_grad_tf32_kernel", step + 62, step + 80),
            _event("Memcpy HtoD (Pageable -> Device)", step + 80, step + 81),
            _event("aten::convolution_backward", step + 40, step + 70, device=False),
        ]
    return events


def test_union_gaps_and_launches():
    out = trace.reduce(_two_steps(), steps=2, window_s=200e-6)
    # device busy 0-40, 60-81 each step: 61 us of 181 from the first to the last
    assert abs(out["busy_s"] - 122e-6) < 1e-12
    assert abs(out["span_s"] - 181e-6) < 1e-12
    assert out["kernels_per_step"] == 5 and out["records_lost"] == 0
    assert out["kernels"]["pad_planes_kernel"]["launches"] == 2
    # the gaps 40-60 and 81-100: a backward op ran over the first
    idle = out["idle_by_host"]
    assert abs(idle["aten::convolution_backward"] - 40e-6) < 1e-12
    assert abs(idle["(no host operation)"] - 19e-6) < 1e-12
    assert abs(trace.idle_pct(out["busy_s"], out["window_s"]) - 39.0) < 1e-9


def test_lost_records_are_counted():
    events = [e for e in _two_steps() if not (e.name.startswith("filter") and
                                              e.time_range.start > 100)]
    assert trace.reduce(events, steps=2, window_s=1.0)["records_lost"] == 1


def test_shared_helper_goes_to_the_next_main_kernel():
    out = trace.reduce(_two_steps(), steps=2, window_s=200e-6)
    conv, n = trace.op_seconds(out, ("conv3x3_stats_tf32_kernel",), (), ("pad_planes_kernel",),
                               ("filter_grad_tf32_kernel",))
    grad, m = trace.op_seconds(out, ("filter_grad_tf32_kernel",), (), ("pad_planes_kernel",),
                               ("conv3x3_stats_tf32_kernel",))
    assert (n, m) == (1, 1)
    assert abs(conv - 25e-6) < 1e-12 and abs(grad - 20e-6) < 1e-12
    nccl, launches = trace.kernel_seconds(out, [r"(?i)nccl"])
    assert launches == 1 and abs(nccl - 20e-6) < 1e-12
