"""The kernel A/B script's and the timing helper's CPU-side parts.

The A/B itself runs only on the card; here: each arm's sources are laid out
with the group size asked for, the script refuses to run without a card,
and ``time_ms`` calls the function as often as it says."""

import pytest
import torch

from exaadmm_tpu_torch import kernel_ab
from exaadmm_tpu_torch.ops import _build
from exaadmm_tpu_torch.utils.timing import time_ms, time_pair


@pytest.mark.parametrize("group", [2, 4, 8])
def test_prepare_arms_sets_the_group(tmp_path, monkeypatch, group):
    monkeypatch.setattr(kernel_ab, "AB_ROOT", tmp_path)
    arms = kernel_ab.prepare_arms([("copy", _build.CSRC)], [group])
    assert [name for name, _ in arms] == ["copy", f"G{group}"]
    for _, src in arms:
        assert {p.name for p in src.iterdir()} >= {
            f"{n}.cu" for n in kernel_ab.SOURCES} | {"tron_alm.cuh"}
    copied = (arms[0][1] / "tron_alm.cuh").read_text()
    assert copied == (_build.CSRC / "tron_alm.cuh").read_text()
    header = (arms[1][1] / "tron_alm.cuh").read_text()
    assert f"constexpr int kGroup = {group};" in header
    assert len(kernel_ab._GROUP_LINE.findall(header)) == 1


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_ab.main(["--groups", "2"]) == 2


def test_time_ms_counts_calls_on_cpu():
    calls = []
    dev = torch.device("cpu")
    device_ms, enqueue_ms = time_ms(lambda: calls.append(1), dev, reps=7,
                                    warmup=3)
    assert len(calls) == 10
    assert device_ms == enqueue_ms >= 0.0
    (a, _), (b, _) = time_pair(lambda: calls.append(2),
                               lambda: calls.append(3), dev, reps=2)
    assert calls.count(2) == calls.count(3) == 2 * (2 + 2)
    assert a >= 0.0 and b >= 0.0
