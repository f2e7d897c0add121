"""chip_smoke.py's attribution of host synchronizations and
device-to-host copies to profiler ranges (`syncs_in_ranges`), on
hand-made events: the card's profiler trace is not available on the CPU.
A device-side copy's start is projected onto the host clock and may fall
before the range whose host op issued it; it must count in that op's
range, once."""
from types import SimpleNamespace

from torch.autograd import DeviceType

import chip_smoke

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


def _event(name, start, end, device=DeviceType.CPU, kernels=()):
    return SimpleNamespace(name=name, device_type=device, kernels=list(kernels),
                           time_range=SimpleNamespace(start=start, end=end))


def test_copies_count_at_the_host_op_that_issued_them():
    copy = "Memcpy DtoH (Device -> Pageable)"
    events = [
        _event("firehose.waves", 0, 100),
        _event("firehose.waves", 0, 130, DeviceType.CUDA),       # device annotation
        _event("firehose.flush", 101, 140),
        _event("aten::add", 10, 12, kernels=[SimpleNamespace(name="kernel")]),
        _event("cudaEventSynchronize", 102, 103),
        _event("aten::copy_", 104, 110, kernels=[SimpleNamespace(name=copy)]),
        _event(copy, 99.5, 100.5, DeviceType.CUDA),               # projected early
        _event("cudaStreamSynchronize", 105, 109),
    ]
    got = chip_smoke.syncs_in_ranges(events, ["firehose.waves", "firehose.flush"])
    assert got == {"firehose.waves": 0, "firehose.flush": 3}
    events.append(_event("cudaStreamSynchronize", 50, 51))        # a real one in the waves
    got = chip_smoke.syncs_in_ranges(events, ["firehose.waves", "firehose.flush"])
    assert got == {"firehose.waves": 1, "firehose.flush": 3}
