"""Each cell driven end to end on the CPU at a small size, with the
harness's look for a card skipped: a sound run is held correct, and the
timed path broken underneath (an answer altered where it is produced, a
step that returns its state unchanged, half of each batch left out) or
run in the program's lower precision (the control) comes out not
correct.  Plus the shape of the line that a run prints."""

import dataclasses
import json
import time

import pytest
import torch

from perfbench import checks, run as bench, serve, train, traffic as gen
from tiny import SERVE, TRAIN, spec

CPU = torch.device("cpu")


def serve_run(program=None, seed=21):
    s = spec(SERVE)
    return serve.run(SERVE, s["desc"], s["traffic"], s["limits"], seed,
                     0.0, False, CPU, time.perf_counter(), program=program)


def train_run(program=None, seed=31):
    s = spec(TRAIN)
    return train.run(TRAIN, s["desc"], s["traffic"], s["limits"], seed,
                     0.0, False, CPU, time.perf_counter(), program=program)


def held(out):
    return checks.held(out["found"], out["limits"])


def test_serving_sound_run_is_correct():
    out = serve_run()
    assert held(out), out["found"]
    assert out["found"]["tail_off"] == 0 and out["found"]["widths_off"] == 0


def test_serving_altered_labels_are_caught():
    def program(desc, params, state, shape, device):
        served, seen, p, g = serve.build(desc, params, state, shape, device)

        def altered(frame):
            out = served(frame).clone()
            out[..., :16] = (out[..., :16] + 1) % desc["num_classes"]
            return out
        return altered, seen, p, g
    out = serve_run(program)
    assert out["found"]["tail_off"] > 0 and not held(out)


def test_serving_altered_logits_are_caught():
    from dcfp_tpu_torch.engine.deploy import (aot_compile_split,
                                              make_split_inference_fn)

    def program(desc, params, state, shape, device):
        _, seen, p, g = serve.build(desc, params, state, shape, device)
        body, tail, dev_params = make_split_inference_fn(
            g, params, state, dtype=torch.bfloat16, output="argmax",
            input_format="nchw", device=device)

        def altered_tail(logits, out_hw):
            with torch.inference_mode():
                logits.mul_(1.05)  # the body's answer, altered in place
            seen["logits"] = logits
            return tail(logits, out_hw)
        run = aot_compile_split(body, altered_tail, dev_params, tuple(shape),
                                input_format="nchw", device=device)
        return (lambda f: run(dev_params, f)), seen, dev_params, g
    out = serve_run(program)
    assert out["found"]["logit_rms_x"] > out["limits"]["logit_rms_x"]
    assert not held(out)


def test_serving_control_int8_is_not_correct():
    from perfbench import calibrate

    def program(desc, params, state, shape, device):
        pool = gen.frames(spec(SERVE)["traffic"], 21, device)
        return calibrate.int8_program(desc, params, state, shape, device,
                                      pool)
    out = serve_run(program)
    assert out["found"]["logit_rms_x"] > out["limits"]["logit_rms_x"]
    assert not held(out)


def test_training_sound_run_is_correct():
    out = train_run()
    assert held(out), out["found"]


def test_training_state_left_unchanged_is_caught(monkeypatch):
    from dcfp_tpu_torch.engine import trainer
    make = trainer.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def same_state(state, batch, generator=None):
            _, metrics = step(state, batch, generator)
            return dataclasses.replace(state, step=state.step + 1), metrics
        return same_state
    monkeypatch.setattr(trainer, "make_train_step", broken)
    out = train_run()
    # nothing moved: each leaf reads min(1, its norm / the median leaf's)
    assert out["found"]["change_median"] > 0.9
    assert not held(out)


@pytest.mark.parametrize("kind", ["half_batch", "bf16_control"])
def test_training_half_batch_and_control_are_caught(kind):
    def program(desc, params, state, device, pool):
        loop, st = train.build(
            desc, params, state, device,
            torch.bfloat16 if kind == "bf16_control" else torch.float32)
        n = pool["img"].shape[1]
        rows = slice(0, n // 2) if kind == "half_batch" else slice(None)
        return loop, st, gen.batch_stream(pool, rows)
    out = train_run(program)
    assert not held(out), out["found"]


def test_result_line_shape(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    s = spec(SERVE)
    out = {"attempted": 7, "failed": 0, "peak": 123,
           "e2e": {"serve_img_per_s": 60.0, "serve_p95_ms": 16.5,
                   "setup_s": 20.0},
           "found": {"logit_rms_x": 0.7, "logit_err_x": 0.8, "tail_off": 0.0,
                     "widths_off": 0.0, "k1_launches_off": 0.0,
                     "label_gap": 0.01},
           "limits": s["limits"]}
    line = bench.line(s, out, False, None)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve_img_per_s", "serve_p95_ms",
                                    "setup_s"}
    assert set(line["checks"]) == set(s["limits"])
    json.dumps(line)


def test_no_card_no_result(capsys):
    rc = bench.main(["--workload", SERVE, "--seed", str(2 ** 31 + 5),
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
