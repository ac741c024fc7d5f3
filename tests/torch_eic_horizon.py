"""The port's EIC horizon against the JAX package's, on the CPU.

The convergence test's model (DeepLabV3-R50, os 8, mg [1,2,4], inplanes
64, 19 classes, align_corner, deepsup, dropout 0) pretrains on 2 x 33^2
batches of its long-tail stream (CE + EIC, SGD poly) three times from
one init, the port's ``init_graph`` carried to the JAX layout by
``bridge.params_to_numpy``: the port, the port from ``perturb(params)``
(its self-noise floor) and ``dcfp_tpu``'s jitted train step.  The rows
of ``dcfp_tpu_torch.prune.horizon.horizon_rows(port, jax, floor)`` go
out in ``tools/exp_eic_horizon.py``'s layout (``total_steps``,
``n_layers``, ``rows``) and are held by ``check_rows``.

    python -m tests.torch_eic_horizon N out.json
"""

import json
import sys
import time

import numpy as np
import torch

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from dcfp_tpu.engine.optim import build_optimizer as j_build_optimizer
from dcfp_tpu.engine.trainer import (create_train_state as
                                     j_create_train_state)
from dcfp_tpu.engine.trainer import make_train_step as j_make_train_step
from dcfp_tpu.losses.criteria import build_criterions as j_build_criterions
from dcfp_tpu_torch import bridge
from dcfp_tpu_torch.graph.apply import init_graph
from dcfp_tpu_torch.prune import horizon
from dcfp_tpu_torch.prune.eic import prunable_bn_names
from tests.test_convergence import build_our_model


def run_jax(model, params, bn, batches, num_steps, checkpoints):
    """``tools/exp_eic_horizon.py:87-104``: the JAX package's pretrain
    loop with EIC snapshots, on JAX-layout numpy params."""
    tx = j_build_optimizer(optim="sgd", learning_rate=horizon.LR,
                           momentum=horizon.MOMENTUM,
                           weight_decay=horizon.WD, num_steps=num_steps,
                           power=horizon.POWER, warmup=0)
    state = j_create_train_state(model, jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, bn), tx,
                                 prune_type="dcfp")
    step = j_make_train_step(
        model, j_build_criterions("ce", ignore_label=horizon.IGNORE,
                                  loss_para={}), tx, eic_r=horizon.EIC_R)
    want = set(checkpoints)
    snaps, losses = {}, []
    for i, b in enumerate(batches[:num_steps]):
        state, m = step(state, jax.tree.map(jnp.asarray, b),
                        jax.random.key(0))
        losses.append(float(m["loss"]))
        if i + 1 in want:
            snaps[i + 1] = {k: np.asarray(v, np.float64).copy()
                            for k, v in state.eic.items()}
    return snaps, losses


def side_by_side(total, checkpoints=None, log=None):
    """The three runs to ``total`` steps and their rows; also each run's
    losses."""
    cps = list(checkpoints or horizon.checkpoints_for(total))
    batches = horizon.make_pretrain_batches(total)
    model = horizon.build_horizon_model(64)
    params, bn = init_graph(model.graph, torch.Generator().manual_seed(0),
                            device="cpu")
    np_params, np_bn = bridge.params_to_numpy(params, bn)
    secs = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[name] = time.perf_counter() - t0
        if log:
            log(f"{name}: {total} steps in {secs[name]:.1f} s")
        return out

    port = timed("port", horizon.run_with_snapshots, model, params, bn,
                 batches, total, cps, device="cpu")
    floor = timed("floor", horizon.run_with_snapshots, model,
                  horizon.perturb(params), bn, batches, total, cps,
                  device="cpu")
    jax_eic, jax_losses = timed("jax", run_jax, build_our_model(), np_params,
                                np_bn, batches, total, cps)
    rows = horizon.horizon_rows(port.eic, jax_eic, floor.eic, model.graph,
                                cps)
    return {"total_steps": total,
            "n_layers": len(prunable_bn_names(model.graph)), "rows": rows,
            "losses": {"port": port.losses, "floor": floor.losses,
                       "jax": jax_losses},
            "cpu_seconds": secs}


def main(argv):
    total = int(argv[0]) if argv else 2000
    out_path = argv[1] if len(argv) > 1 else "eic_horizon_torch.json"
    res = side_by_side(total, log=lambda s: print(s, flush=True))
    for row in res["rows"]:
        print(json.dumps(row), flush=True)
    out = {k: res[k] for k in ("total_steps", "n_layers", "rows",
                               "cpu_seconds")}
    out["losses_first_last_10"] = {k: [v[:10], v[-10:]]
                                   for k, v in res["losses"].items()}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_path}", flush=True)
    horizon.check_rows(res["rows"])


if __name__ == "__main__":
    main(sys.argv[1:])
