"""The rank programs of ``tests/test_torch_mesh_train.py``: four CPU
processes on ``gloo`` training the smoke models on a 2 × 2 ``("data",
"model")`` mesh (and resuming on 4 × 1 and 1 × 4), and eight running the
pod pipeline.  Each rank saves what it computed for the test module to
hold against the reference.  Imports no JAX: the reference runs in the
test process.

Every scenario runs on every rank in the same order (the collectives
pair up across ranks).  A scenario that raises ends the run on that rank
and its traceback is saved; the other ranks then fail in their next
collective at the group's timeout.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60


def _np(t):
    return t.detach().float().cpu().numpy()


def _model(inp, name):
    from repro_torch.models.lm import LM

    case = inp["cases"][name]
    model = LM(case["cfg"], device="cpu")
    model.load_state_dict(case["state"])
    return model


def _trainer(inp, name, folder, *, mesh, steps=2, **tc):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    case = inp["cases"][name]
    opt = {**inp["opt"], **tc.pop("opt", {})}
    tcfg = TrainConfig(steps=steps, checkpoint_dir=os.path.join(inp["out_dir"], folder), log_every=1000,
                       **{"checkpoint_every": 1000, **tc})
    return Trainer(case["cfg"], DataConfig(**case["data"]), AdamWConfig(**opt), tcfg, mesh=mesh, device="cpu")


def _blocks(model) -> dict:
    """This rank's parameter blocks: values and offsets."""
    return {k: {"value": _np(p), "offset": model.blocks[k].offset, "global_shape": model.blocks[k].global_shape}
            for k, p in model.named_parameters()}


def _run(inp, name, folder, *, mesh, resume=False, model=None, **kw) -> dict:
    t = _trainer(inp, name, folder, mesh=mesh, **kw)
    out = t.run(resume=resume, model=model if model is not None else _model(inp, name))
    res = {"losses": [h["loss"] for h in out["history"]], "steps": [h["step"] for h in out["history"]],
           "skipped": [h["skipped"] for h in out["history"]], "grad_norm": [h["grad_norm"] for h in out["history"]],
           "state_bytes": t.state_bytes, "resumed": t.resumed}
    if mesh is not None:
        res["blocks"] = _blocks(out["model"])
        if out["ef"] is not None:
            res["ef"] = {k: _np(v) for k, v in out["ef"].residual.items()}
    else:
        res["params"] = {k: _np(p) for k, p in out["model"].named_parameters()}
        if out["ef"] is not None:
            res["ef"] = {k: _np(v) for k, v in out["ef"].residual.items()}
    res["trainer"] = t
    return res


def _plain(res) -> dict:
    res = dict(res)
    res.pop("trainer", None)
    return res


def _collectives() -> dict:
    from repro_torch.distributed.layout import COLLECTIVES

    out = dict(COLLECTIVES)
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))
    return out


def configs(mesh, inp) -> dict:
    """Each case two f32 steps on the 2 × 2 mesh; rank 0 also unsharded."""
    out = {}
    for name in inp["cases"]:
        _collectives()
        res = _plain(_run(inp, name, f"cfg_{name}", mesh=mesh))
        res["collectives"] = _collectives()
        if dist.get_rank() == 0:
            res["unsharded"] = _plain(_run(inp, name, f"cfg_{name}_plain", mesh=None))
        out[name] = res
    return out


def gemma(mesh, inp) -> dict:
    """The gemma-2b smoke model (FAµST head): EF, a forced clip, a NaN
    step, microbatches and a recompression tick on the mesh, each beside
    its unsharded run on rank 0."""
    name = "gemma_2b"
    runs = {
        "ef": dict(compression=inp["ef"]),
        "clip": dict(opt={"grad_clip": 1e-3}),
        "micro": dict(microbatches=2),
        "recompress": dict(recompress_every=2, recompress_targets=("embed/table",)),
    }
    out = {}
    for key, kw in runs.items():
        full = _run(inp, name, f"gemma_{key}", mesh=mesh, **kw)
        res = _plain(full)
        if key == "recompress":
            res["log"] = full["trainer"]._recompress_log
        if dist.get_rank() == 0:
            res["unsharded"] = _plain(_run(inp, name, f"gemma_{key}_plain", mesh=None, **kw))
        out[key] = res
    # a NaN in the embedding table: every rank skips, the parameters stay
    model = _model(inp, name)
    with torch.no_grad():
        model.embed.table[0, 0] = float("nan")
    out["nan"] = _plain(_run(inp, name, "gemma_nan", mesh=mesh, steps=1, model=model))
    return out


def preempt(mesh, inp) -> dict:
    """SIGTERM on rank 2 during step 1 of 4: every rank saves step 2 and
    stops; that checkpoint resumed on 4 × 1, 1 × 4 and (rank 0)
    unsharded, each for the third step; then a corrupted shard of step 2
    makes ``restore_latest`` fall back to step 1 on every rank."""
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.runtime import trainer as tr

    name = "gemma_2b"
    t = _trainer(inp, name, "preempt", mesh=mesh, steps=4, checkpoint_every=1)
    beat = t._heartbeat

    def heartbeat(step):
        beat(step)
        if step == 1 and dist.get_rank() == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    t._heartbeat = heartbeat
    run = t.run(resume=False, model=_model(inp, name))
    out = {"steps": [h["step"] for h in run["history"]], "losses": [h["loss"] for h in run["history"]],
           "saved": [s["step"] for s in t.saves], "on_disk": t.ckpt.all_steps()}
    folder = os.path.join(inp["out_dir"], "preempt")
    for shape in ((4, 1), (1, 4)):
        m = make_debug_mesh(*shape)
        t2 = tr.Trainer(t.cfg, t.data_cfg, t.opt_cfg, dataclasses.replace(t.tcfg, steps=3, checkpoint_every=1000),
                        mesh=m, device="cpu")
        res = t2.run(resume=True, model=_model(inp, name))
        out[shape] = {"steps": [h["step"] for h in res["history"]], "losses": [h["loss"] for h in res["history"]],
                      "resumed": t2.resumed["step"], "shapes": {k: tuple(p.shape) for k, p in res["model"].named_parameters()}}
    if dist.get_rank() == 0:
        t3 = tr.Trainer(t.cfg, t.data_cfg, t.opt_cfg, dataclasses.replace(t.tcfg, steps=3, checkpoint_every=1000),
                        device="cpu")
        t3.ckpt = tr.CheckpointManager(folder, keep=t.tcfg.keep_checkpoints)
        res = t3.run(resume=True, model=_model(inp, name))
        out["unsharded"] = {"steps": [h["step"] for h in res["history"]], "losses": [h["loss"] for h in res["history"]],
                            "resumed": t3.resumed["step"]}
        out["uninterrupted"] = _plain(_run(inp, name, "preempt_plain", mesh=None, steps=3))["losses"]
    dist.barrier()
    # a corrupted shard of step 2: every rank falls back to step 1
    if dist.get_rank() == 0:
        step2 = os.path.join(folder, "2")
        victim = sorted(f for f in os.listdir(step2) if f.startswith("params__layers.1.attn.wq@"))[-1]
        with open(os.path.join(step2, victim), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            f.write(b"\xff\xff\xff\xff")
        out["corrupted"] = victim
    dist.barrier()
    t4 = _trainer(inp, name, "preempt", mesh=mesh, steps=2)
    res = t4.run(resume=True, model=_model(inp, name))
    out["fallback"] = {"resumed": t4.resumed["step"], "steps": [h["step"] for h in res["history"]]}
    return out


def planted(mesh, inp) -> dict:
    """Keys and values not gathered under the sequence split: each chunk
    attends only to itself."""
    from repro_torch.layers import attention

    real = attention.gather_kv
    attention.gather_kv = lambda k, v, seq: (k, v, seq.positions(k.device))
    try:
        return _plain(_run(inp, "gemma_2b", "planted", mesh=mesh))
    finally:
        attention.gather_kv = real


def refusals(mesh, inp) -> dict:
    """``launch.train --mesh`` on this 4-rank group (the production mesh
    needs 256 ranks), and mamba2 under a policy that splits the sequence."""
    from repro_torch.configs.base import CP_POLICY
    from repro_torch.launch import train

    out = {}
    args = train.parse_args(["--arch", "gemma_2b", "--smoke", "--steps", "1", "--mesh", "--device", "cpu",
                             "--checkpoint-dir", os.path.join(inp["out_dir"], "launch")])
    try:
        train.build(args)
        out["launcher"] = None
    except ValueError as e:
        out["launcher"] = str(e)
    case = inp["cases"]["mamba2_2p7b"]
    cp = {**inp, "cases": {"mamba2_2p7b": {**case, "cfg": dataclasses.replace(case["cfg"], policy=CP_POLICY)}}}
    try:
        _run(cp, "mamba2_2p7b", "ssd_split", mesh=mesh, steps=1)
        out["ssd_split"] = None
    except NotImplementedError as e:
        out["ssd_split"] = str(e)
    return out


SCENARIOS = (configs, gemma, preempt, planted, refusals)


def _join(rank: int, world: int, rendezvous: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def run(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """One rank of the trainer's group: every scenario on a 2 × 2 mesh,
    the results saved to ``out_dir/rank{rank}.pt``."""
    _join(rank, world, rendezvous)
    results: dict = {}
    try:
        from repro_torch.distributed import make_debug_mesh

        inp = torch.load(inputs, weights_only=False)
        inp["out_dir"] = out_dir
        mesh = make_debug_mesh(2, 2)
        results["mesh"] = {"coord": dict(mesh.coord)}
        for fn in SCENARIOS:
            results[fn.__name__] = fn(mesh, inp)
    except Exception:  # noqa: BLE001 — saved for the test module to report
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def run_pipeline(rank: int, world: int, rendezvous: str, inputs: str, out_dir: str) -> None:
    """One rank of the pipeline's group: ``pipeline_apply`` on a pod 4 ×
    data 2 mesh, then its backward for the loss ``Σ y · gy``: the result,
    ``dx`` and the stage parameters' gradients saved to
    ``out_dir/pipe{rank}.pt``."""
    _join(rank, world, rendezvous)
    results: dict = {}
    try:
        from repro_torch.distributed.mesh import Mesh
        from repro_torch.distributed.pipeline import pipeline_apply

        inp = np.load(inputs)
        mesh = Mesh((4, 2), ("pod", "data"))
        params = {"w": torch.as_tensor(inp["w"]).requires_grad_(), "b": torch.as_tensor(inp["b"]).requires_grad_()}
        x = torch.as_tensor(inp["x"]).requires_grad_()
        y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params, x,
                           mesh=mesh, axis="pod", n_microbatches=int(inp["n_micro"]))
        (y * torch.as_tensor(inp["gy"])).sum().backward()
        results = {"y": _np(y), "coord": dict(mesh.coord), "dx": _np(x.grad),
                   "dw": _np(params["w"].grad), "db": _np(params["b"].grad)}
    except Exception:  # noqa: BLE001 — saved for the test module to report
        results["error"] = traceback.format_exc()
    finally:
        torch.save(results, os.path.join(out_dir, f"pipe{rank}.pt"))
        dist.destroy_process_group()
