"""The jax-free half of the port's parity helpers: the port's side of a
method's steps (`port_method_runs`), which tests/_torch_port_util.py
re-exports beside the JAX side, and the spawned ranks of
tests/test_torch_port_parallel.py (`spawn`), processes that import torch
and the port but never JAX, as the port's ranks on a GPU machine do.

A spawn starts `world` processes with torch.multiprocessing, which join one
gloo process group through a file store in the test's tmp_path, run
`work(rank, world, *args)` (a module-level function, so that a spawned
process finds it by name) at one intra-op thread each, and hand back its
return value through a file.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist


def load_sd(module, sd):
    """Copy {torch name: numpy} into the module's tensors of those names."""
    with torch.no_grad():
        for k, t in module.state_dict().items():
            if k in sd:
                t.copy_(torch.from_numpy(np.asarray(sd[k])))


def load_adam(optimizer, named, mu, nu):
    """Adam's moments from {torch name: numpy}. A parameter that has had no
    gradient yet has no torch state; JAX's moments of it are zeros (the
    deep-supervision heads that cps never reads)."""
    with torch.no_grad():
        for k, p in named.items():
            st = optimizer.state[p]
            if "exp_avg" not in st:
                assert not mu[k].any() and not nu[k].any(), k
                continue
            st["exp_avg"].copy_(torch.from_numpy(mu[k]))
            st["exp_avg_sq"].copy_(torch.from_numpy(nu[k]))


def port_net_record(module, optimizer):
    """The port's net as _jax_net_record's: its state dict and Adam's
    moments (zeros for a parameter with no torch state yet)."""
    named = dict(module.named_parameters())
    moments = {"mu": {}, "nu": {}}
    for k, p in named.items():
        st = optimizer.state[p]
        for moment, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments[moment][k] = (st[name].numpy().copy() if name in st
                                  else np.zeros(tuple(p.shape), np.float64))
    return {"sd": {k: v.detach().clone().numpy()
                   for k, v in module.state_dict().items()}, **moments}


def port_method_runs(pmethod, pcfg, make_model, batches, starts, jax_runs,
                     teacher=False, make_second=None, group=None):
    """The port's steps of `pmethod` on `batches` from each step count of
    `starts`, a fresh `make_model()` each time (and, with `teacher`, the
    mean teacher as its copy; with `make_second`, cps's net 2 as
    `make_second()` with its own Adam), with the kernel shape gates opened
    at the images' levels 0 and 1 (`open_gates`), so that their convs and
    pools go through the kernel modules (their plain versions on the CPU)
    as at 256 and 128 px on the GPU: {start: [one record a step, as
    jax_method_runs's]}.

    Every step after the first starts from JAX's state after the step
    before (`jax_runs`: params, BN stats, the teacher, net 2, Adam's
    moments), once the port's own state after that step is recorded (and
    compared by check_method_steps). Run on from its own state, the port
    drifted from JAX at step 2 beyond check_params' tolerances in places
    (cct past the ramp, ucc from step 0): the f32 logits heads of both
    packages leave gradient noise that decides Adam's step-1 update of the
    elements whose gradient is near Adam's eps, and the parameters that
    differ so move some LeakyReLU input of step 2 across its kink at 2 x
    16 x 128.

    With a process group (`group`), the steps are this rank's, each on its
    rows of the global batches (shard_map or GSPMD mode as
    pcfg.run.use_shard_map says: methods/base.py `step_ranks`)."""
    from uaps_tpu_torch.methods import base
    from uaps_tpu_torch.parallel.mesh import local_batch_shard

    if group is not None:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        batches = [local_batch_shard(b, rank, world) for b in batches]

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        open_gates(mp, next(v for k, v in batches[0].items()
                            if k in ("image", "mix_img_l")).shape[2])
        for start in starts:
            model = make_model()
            state = base.init_model_state(pcfg, model)
            if teacher:
                state.ema_model = base.make_teacher(model)
            nets = [(model, lambda: state.optimizer, "")]
            if make_second is not None:
                m2 = make_second()
                state.second = base.SecondNet(m2, base.make_optimizer(
                    m2.parameters(), pcfg.optim, "cpu"))
                nets.append((m2, lambda: state.second.optimizer, "second"))
            state.step = start
            step = pmethod.make_train_step(pcfg, model, group=group)
            runs[start] = []
            for i, b in enumerate(batches):
                if i:
                    prev = jax_runs[start][i - 1]
                    if teacher:
                        load_sd(state.ema_model, prev["ema"])
                    for net, opt, key in nets:
                        rec = prev[key] if key else prev
                        load_sd(net, rec["sd"])
                        load_adam(opt(), dict(net.named_parameters()),
                                  rec["mu"], rec["nu"])
                state, m = step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
                runs[start].append({
                    "metrics": {k: float(v) for k, v in m.items()},
                    **port_net_record(model, state.optimizer),
                    "ema": ({k: v.detach().clone().numpy() for k, v in
                             state.ema_model.state_dict().items()}
                            if teacher else None),
                    "second": (port_net_record(state.second.model,
                                               state.second.optimizer)
                               if make_second is not None else None)})
            assert state.step == int(state.counter) == start + len(batches)
    return runs


def open_gates(mp, width=0):
    """Open the kernel shape gates (`conv_kernel_ok`, `pool_pallas_ok`) of
    the port's model through the monkeypatch `mp`: the conv gate for
    inputs at least width / 2 wide within its channel limits, so that in a
    net on images `width` wide levels 0 and 1 pass, as JAX's gate admits
    the 256 and 128 px levels on the card and no deeper one (width 0: a
    lone block passes); a conv there goes through the kernel module (its
    plain version on the CPU). The pools still follow nchw_levels."""
    from uaps_tpu_torch.kernels.conv3x3_nchw import MAX_COUT
    from uaps_tpu_torch.models import unet as tunet
    mp.setattr(tunet, "conv_kernel_ok", lambda h, w, cin, cout: (
        w >= width // 2 and cout <= MAX_COUT and cin <= 64))
    mp.setattr(tunet, "pool_pallas_ok", lambda x: True)


def _rank(rank, world, store, out, work, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(work(rank, world, *args), os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(work, args, world, tmp_path):
    """[work(rank, world, *args) for each rank], run in `world` spawned
    processes joined over gloo (the module docstring)."""
    out = tmp_path / f"ranks-{work.__name__}"
    out.mkdir()
    torch.multiprocessing.spawn(
        _rank, args=(world, str(out / "store"), str(out), work, args),
        nprocs=world)
    return [torch.load(out / f"{r}.pt", weights_only=False)
            for r in range(world)]


def make_net(kind, kwargs, sd):
    """A port net of class `kind` (models/unet.py) with state dict sd."""
    from uaps_tpu_torch.models import unet as tunet
    net = getattr(tunet, kind)(**kwargs)
    net.load_state_dict(sd)
    return net


def _case_runs(case, group):
    from uaps_tpu_torch.methods import get_method
    return port_method_runs(
        get_method(case["method"]), case["cfg"], case["make"],
        case["batches"], case["starts"], case["jruns"],
        teacher=case["teacher"], make_second=case["make_second"],
        group=group)


class _ValData:
    def __init__(self, batches):
        self.batches = batches

    def val_iter(self):
        return iter(self.batches)


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def trainer_case(rank, world, cfg, val, train, make):
    """A Trainer on this rank: its validation (its eval step on `make()`)
    over the val batches, one train step on its rows of `train`, a save,
    and a fresh Trainer resumed from it: {"validate", "step",
    "resume_equal", "digest"}."""
    from uaps_tpu_torch import train as ptrain
    from uaps_tpu_torch.methods import base
    from uaps_tpu_torch.parallel.mesh import local_batch_shard
    from uaps_tpu_torch.utils.checkpoint import state_tensors

    t = ptrain.Trainer(cfg, device="cpu", data=_ValData(val))
    t.eval_steps = [("val_", base.make_eval_step(cfg, make()))]
    out = {"validate": t.validate()}
    batch = {k: torch.from_numpy(v)
             for k, v in local_batch_shard(train, rank, world).items()}
    t.state, _ = t.train_step(t.state, batch)
    t.save(1, {"val_mdice": 0.5})
    again = ptrain.Trainer(cfg, device="cpu", data=_ValData(val))
    again.maybe_resume()
    saved = state_tensors(t.state, t.model)
    got = state_tensors(again.state, again.model)
    out["resume_equal"] = (saved.keys() == got.keys() and all(
        torch.equal(saved[k], got[k]) for k in saved))
    out["step"] = again.state.step
    out["digest"] = _digest(saved)
    return out


def method_cases(rank, world, cases, extra):
    """This rank's runs of every case over the whole group, and the extra
    work: "one" (methods whose case also runs over a group of this rank
    alone and without a group), "trainer" (trainer_case's arguments),
    "dropout" (one more case over the whole group), "kernel_route" (a
    config and a model whose GSPMD step must refuse to build: the
    message)."""
    runs = {m: _case_runs(c, dist.group.WORLD) for m, c in cases.items()}
    out = {}
    if "one" in extra:
        alone = [dist.new_group([r]) for r in range(world)][rank]
        out["one"] = {m: (_case_runs(cases[m], alone),
                          _case_runs(cases[m], None))
                      for m in extra["one"]}
    if "trainer" in extra:
        out.update(trainer_case(rank, world, *extra["trainer"]))
    if "dropout" in extra:
        out["dropout"] = _case_runs(extra["dropout"], dist.group.WORLD)
    if "kernel_route" in extra:   # a GSPMD step on the kernel route
        from uaps_tpu_torch.methods import get_method
        cfg, make = extra["kernel_route"]
        try:
            get_method("baseline").make_train_step(cfg, make(),
                                                   group=dist.group.WORLD)
            out["kernel_route"] = None
        except ValueError as e:
            out["kernel_route"] = str(e)
    return {"runs": runs, "extra": out}
