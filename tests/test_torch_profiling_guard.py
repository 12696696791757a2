"""utils/profiling.trace's guard against a window that lost the card's
events: ``check_device_events`` on a window's events, made here (the CPU
records no device event; tests/test_torch_profiling_plots.py runs ``trace``
itself on the CPU)."""

import pytest
import torch

from sdf_representation_tpu_torch.utils import profiling

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, device_type):
        self._name, self._device_type = name, device_type

    def name(self):
        return self._name

    def device_type(self):
        return self._device_type


WINDOWS = {  # events -> raises
    "launches_and_kernels": ([("aten::mm", CPU), ("cudaLaunchKernel", CPU),
                              ("ampere_bf16_gemm", CUDA)], False),
    "graph_replay_and_kernels": ([("cudaGraphLaunch", CPU), ("igr_fwd_kernel", CUDA)], False),
    "launches_and_no_device_event": ([("aten::mm", CPU), ("cudaLaunchKernel", CPU),
                                      ("cudaMemcpyAsync", CPU)], True),
    "graph_replay_and_no_device_event": ([("cudaGraphLaunch", CPU)], True),
    "host_work_only": ([("aten::add", CPU), ("aten::empty", CPU)], False),
}


@pytest.mark.parametrize("window", WINDOWS)
def test_a_window_that_lost_the_cards_events_raises(window):
    events, raises = WINDOWS[window]
    events = [_Event(*e) for e in events]
    if raises:
        with pytest.raises(profiling.NoDeviceEvents, match="no event on the card"):
            profiling.check_device_events(events)
    else:
        profiling.check_device_events(events)

