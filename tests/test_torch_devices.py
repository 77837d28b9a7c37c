"""Which card the port launches on, and the profiler option.

On the CPU, with ``torch.cuda.set_device``, ``torch.cuda.device`` and
``torch.cuda.current_stream`` replaced by recorders:

- ``runner.train_or_infer`` with ``gpu=k`` makes ``cuda:k`` the current card
  before it builds anything on it;
- ``build.stream(device)`` is the current stream of that device, and a
  ``Kernel`` launches with its device current and on that stream;
- ``logging.profile_dir``, which raised NotImplementedError before the
  profiler hook was ported, is accepted by ``train_or_infer`` and
  ``Trainer`` (the trace itself: ``tests/test_torch_parallel.py``).
"""

import contextlib
import types

import pytest
import torch

from lagrangebench_torch import runner
from lagrangebench_torch.config import Config, merge
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.ops import build
from lagrangebench_torch.train import Trainer


class _Stop(Exception):
    pass


def _cfg(**logging):
    return merge(defaults, Config({
        "dataset": {"src": "unused"},
        "model": {"name": "gns", "input_seq_length": 6},
        "neighbors": {"backend": "auto"},
        "logging": logging,
    }))


def _stub_data():
    split = types.SimpleNamespace(metadata={"bounds": [[0.0, 1.0]] * 3},
                                  external_force_fn=None)
    return split, split, split


@pytest.mark.parametrize("gpu,want", [(1, [torch.device("cuda:1")]), (0, [torch.device("cuda:0")]),
                                      (None, []), (-1, [])])
def test_runner_makes_the_configured_card_current(monkeypatch, gpu, want):
    """gpu=k calls torch.cuda.set_device(cuda:k) before the case is built;
    gpu=None keeps the current card and gpu=-1 (the CPU) sets none."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(torch.device(d)))

    def case_builder(**kw):
        assert calls == want  # the card is current before anything is built
        assert kw["device"] == runner.device_from_gpu(gpu)
        raise _Stop

    monkeypatch.setattr(runner, "case_builder", case_builder)
    cfg = _cfg()
    cfg.gpu = gpu
    with pytest.raises(_Stop):
        runner.train_or_infer(cfg, data=_stub_data())


def _fake_cuda(monkeypatch, log):
    """torch.cuda.device / current_stream recorders: stream handles are
    1000 + the device index, and ``log`` gets the current card at each
    stream lookup and launch."""
    state = {"current": 0}

    @contextlib.contextmanager
    def device(d):
        before = state["current"]
        state["current"] = torch.device(d).index
        log.append(("enter", state["current"]))
        try:
            yield
        finally:
            state["current"] = before

    def current_stream(d=None):
        idx = state["current"] if d is None else torch.device(d).index
        log.append(("stream", idx))
        return types.SimpleNamespace(cuda_stream=1000 + idx)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return state


@pytest.mark.parametrize("index", [0, 1, 3])
def test_stream_is_the_tensors_device_stream(monkeypatch, index):
    log = []
    _fake_cuda(monkeypatch, log)
    s = build.stream(torch.device(f"cuda:{index}"))
    assert s.value == 1000 + index
    assert log == [("stream", index)]


@pytest.mark.parametrize("index", [0, 2])
def test_kernel_launches_on_its_device_and_stream(monkeypatch, index):
    """A Kernel call makes the tensors' card current for the C entry, passes
    that card's stream last, and counts the launch."""
    log = []
    state = _fake_cuda(monkeypatch, log)
    seen = []

    def entry(*args):
        seen.append((state["current"], args))
        return 0

    kernel = build.Kernel("probe", "none", "none", [], replaces="none")
    kernel._fn = entry
    kernel(7, 8, device=torch.device(f"cuda:{index}"))
    assert seen[0][0] == index
    assert seen[0][1][:2] == (7, 8) and seen[0][1][2].value == 1000 + index
    assert ("enter", index) in log and kernel.launches == 1
    assert state["current"] == 0  # restored after the launch


def test_kernel_raises_and_does_not_count_a_refused_launch(monkeypatch):
    _fake_cuda(monkeypatch, [])
    kernel = build.Kernel("probe", "none", "none", [], replaces="none")
    kernel._fn = lambda *args: 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        kernel(device=torch.device("cuda:1"))
    assert kernel.launches == 0


def test_runner_refuses_profile_dir(monkeypatch, tmp_path):
    """The refusal is gone: with ``logging.profile_dir`` set the runner goes
    on to build the case."""
    monkeypatch.setattr(runner, "case_builder", lambda **kw: (_ for _ in ()).throw(_Stop()))
    cfg = _cfg(profile_dir=str(tmp_path / "trace"))
    cfg.gpu = -1
    with pytest.raises(_Stop):
        runner.train_or_infer(cfg, data=_stub_data())


def test_trainer_refuses_profile_dir(tmp_path):
    """The refusal is gone: with ``logging.profile_dir`` set the trainer goes
    on to read its splits (here None, which fails there)."""
    case = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(AttributeError, match="subseq_length"):
        Trainer(None, case, None, None, cfg_logging={"profile_dir": str(tmp_path)},
                device="cpu")
