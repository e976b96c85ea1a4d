"""The check that decides ``correct``, at smoke size on the CPU: the whole
run (the harness's look for a card skipped), its sound runs inside the
limit, the float8 control and planted faults outside it.

The smoke limit comes from the same readings as a cell's (steps 4 and 5 of
PERF.md's limits): on seeds 1..12 the program's widest gap read at most
0.0250 and the control's at least 0.216, so 0.08 lies above the one and
below the other with room on both sides."""
import time

import pytest

from benchkit import spec
from benchkit.runner import run_cell
from smoke import TRAFFIC, smoke_config

SMOKE_LIMIT = 0.08


def smoke_run(monkeypatch, seed, control=False):
    monkeypatch.setattr(spec, "limits", lambda name, bench_dir=None: {
        "logit_gap": {"limit": SMOKE_LIMIT}})
    metrics = tuple(m for m in spec.resolve(
        "internlm-1.8b.decode_heavy").metrics if m.layer is None)
    cell = spec.Cell("smoke", 1, smoke_config("internlm-1.8b"), TRAFFIC,
                     metrics)
    return run_cell(cell, seed=seed, seconds=1.5, trace=False,
                    t0=time.monotonic(), device="cpu", control=control,
                    smoke=True)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 32 + 5, 77])
def test_sound_runs_pass_and_the_control_fails(monkeypatch, seed):
    r = smoke_run(monkeypatch, seed, control=True)
    assert r["correct"], r["check"]
    assert r["check"]["logit_gap"]["value"] <= SMOKE_LIMIT
    assert not r["control_correct"], r["check"]
    assert r["check"]["control_gap"]["value"] > SMOKE_LIMIT
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms",
                                 "output_tok_s", "setup_s"}


def _alter_decoded(monkeypatch):
    """Every decode window's first token of each lane off by one, where
    the batcher hands it to the request."""
    from repro_torch.serving import scheduler
    emit = scheduler.PagedBatcher._emit

    def wrong(self, i, emitted):
        if emitted:
            emitted = [(emitted[0] + 1) % self.cfg.vocab_size, *emitted[1:]]
        return emit(self, i, emitted)

    monkeypatch.setattr(scheduler.PagedBatcher, "_emit", wrong)


def _alter_first(monkeypatch):
    """The token the prefill samples, off by one."""
    from repro_torch.serving import scheduler
    sample = scheduler.sample

    def wrong(logits, generator, cfg):
        return (sample(logits, generator, cfg) + 1) % logits.shape[-1]

    monkeypatch.setattr(scheduler, "sample", wrong)


@pytest.mark.parametrize("fault", [_alter_decoded, _alter_first],
                         ids=["decoded-token", "first-token"])
def test_an_altered_token_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    r = smoke_run(monkeypatch, 2 ** 31 + 11)
    assert not r["correct"]
    assert r["check"]["logit_gap"]["value"] > SMOKE_LIMIT
