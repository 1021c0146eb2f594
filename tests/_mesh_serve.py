"""What the model-axis serving test modules share
(``test_torch_mesh_serve.py``: the attention families, MLA, the moves of
a recorded step and the partials' merge; ``test_torch_mesh_serve_mixers.py``:
the MoEs, the recurrent families and the encoder-decoder): the smokes'
seed-0 parameters and inputs, the port's ``MeshServe`` run on 8 CPU
slots (split or gathered), the reference's ``api.prefill`` /
``api.decode`` jitted at the same shardings on its host mesh, the
unmeshed step on each data shard's rows, each computed once a case, and
the checks of one against another (see ``test_torch_mesh_serve.py``'s
docstring for the sizes and the tolerance)."""
import functools

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import SMOKES as J_SMOKES
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe, cache_geometry
from repro_torch.models import build, layers as L
from repro_torch.train import sharded as S
from _model_axis import ROW_PARALLEL, smoke as _smoke

CPU = "cpu"
SPLIT = ("llama3.2-3b", "gemma3-12b", "gemma3-27b", "internvl2-76b",
         "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
         "xlstm-125m", "seamless-m4t-large-v2")
CASES = [(m, False) for m in ((1, 8), (2, 4), (4, 2))] \
    + [(m, True) for m in ((2, 4), (4, 2))]
# MLA (not in long mode, which it does not split), and with a vocabulary
# of 500, which degree 8 does not divide: the row-parallel embedding and
# logits, tied (minicpm3-4b, llama3.2-3b) and untied (phi3.5-moe's head)
MLA = ("minicpm3-4b",) + ROW_PARALLEL
TOL = 1e-5
BATCH, PROMPT, SEQ, STEPS, FRAMES = 8, 16, 32, 3, 8


def _ids(case):
    (d, m), long_mode = case
    return f"{d}x{m}" + ("-long" if long_mode else "")


@functools.lru_cache(maxsize=None)
def _setup(name, tp):
    """The reference's seed-0 parameters at model degree ``tp`` (its
    tree, in numpy) and the inputs: tokens (B, PROMPT + STEPS) and a
    VLM's patches, from a numpy seed."""
    jcfg = _smoke(J_SMOKES, name)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=tp).init_params(0))
    rng = np.random.default_rng(0)
    inp = {"tokens": rng.integers(0, jcfg.vocab_size,
                                  (BATCH, PROMPT + STEPS)).astype(np.int32)}
    if jcfg.num_patches:
        inp["patches"] = rng.standard_normal(
            (BATCH, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "encdec":
        inp["frames"] = rng.standard_normal(
            (BATCH, FRAMES, jcfg.d_model)).astype(np.float32)
    return jp, inp


def _steps(name, long_mode):
    """(batch of the prefill, list of decode batches) in numpy: batch 1
    in long mode."""
    _, inp = _setup(name, 1)
    b = 1 if long_mode else BATCH
    pre = _smoke(SMOKES, name).num_patches
    first = {"tokens": inp["tokens"][:b, :PROMPT]}
    for k in ("patches", "frames"):
        if k in inp:
            first[k] = inp[k][:b]
    steps = [{"tokens": inp["tokens"][:b, i:i + 1],
              "lengths": np.full((b,), i + pre, np.int32)}
             for i in range(PROMPT, PROMPT + STEPS)]
    return first, steps


def _serve(name, mesh_shape, long_mode, split=True, monkeypatch=None,
           sends=None):
    """The port's MeshServe on 8 CPU slots: (each step's logits, the
    caches after the last step), gathered, in numpy, the serve, the
    caches as laid out, and each step's logits blocks' shapes; ``sends``,
    where given, collects (src, dst, storage) of every move between
    slots."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    cfg = _smoke(SMOKES, name)
    api = build(cfg, tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    serve = MeshServe(api, mesh, long_mode=long_mode)
    assert serve.split or not split
    serve.split = split
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    params = serve.params = serve.lay_out_params(
        api.params_from_numpy(jp, CPU))
    caches = serve.init_caches(b, SEQ + cfg.num_patches)
    if sends is not None:
        send = S.send

        def recording(t, mesh_, src, dst, out=None):
            if src is not None and src != dst:
                sends.append((src, dst, t.untyped_storage().data_ptr()))
            return send(t, mesh_, src, dst, out=out)
        monkeypatch.setattr(S, "send", recording)
    logits, shapes = [], []
    with torch.no_grad():
        lg, caches, *enc = serve.prefill(params, serve.lay_out_inputs(
            {k: torch.from_numpy(v) for k, v in first.items()}), caches)
        for batch in [None] + steps:
            if batch is not None:
                inputs = serve.lay_out_inputs(
                    {k: torch.from_numpy(v) for k, v in batch.items()})
                if enc:                     # the encoder's output, laid out
                    inputs["enc_out"] = enc[0]
                lg, caches = serve.decode(params, inputs, caches)
            logits.append(S.gather(lg).numpy().copy())
            shapes.append({tuple(b.shape) for b in lg.blocks})
    if sends is not None:
        monkeypatch.undo()
    return logits, [t.numpy().copy() for t in
                    L.tree_leaves(S.gather_tree(caches))], serve, caches, \
        shapes


@functools.lru_cache(maxsize=None)
def _outputs(name, mesh_shape, long_mode, split=True):
    """:func:`_serve`'s logits, caches, serve and logits blocks' shapes,
    once for each case."""
    out = _serve(name, mesh_shape, long_mode, split=split)
    return out[:3] + out[4:]


@functools.lru_cache(maxsize=None)
def _reference(name, mesh_shape, long_mode):
    """The reference's prefill and decode steps jitted with the port's
    layouts as NamedShardings on its (d, m) host mesh, under its
    ``use_mesh`` (DP resolved to no axes in long mode, as its dry run
    does): each step's logits and the final caches, in numpy."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    jcfg = _smoke(J_SMOKES, name)
    api = jbuild(jcfg, tp=m)
    port = MeshServe(build(_smoke(SMOKES, name), tp=m),
                     make_host_mesh(devices=[CPU] * (d * m),
                                    shape=mesh_shape), long_mode=long_mode)
    jmesh = j_make_host_mesh(d * m, shape=mesh_shape)
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    seq = SEQ + jcfg.num_patches

    def ns(spec):
        return NamedSharding(jmesh, JP(*spec))

    c_sh = L.tree_map(lambda p: ns(p), port.cache_specs(b, seq))
    c_sh = jax.tree.unflatten(jax.tree.structure(
        api.cache_defs(b, seq, long_mode=long_mode),
        is_leaf=lambda x: isinstance(x, JL.ParamDef)), L.tree_leaves(c_sh))
    caches = JL.init_tree(api.cache_defs(b, seq, long_mode=long_mode))
    lg_sh = ns(port.logits_spec)

    def in_sh(batch):
        return {k: ns(lay.spec) for k, lay in port.input_layouts(
            {k: torch.from_numpy(v) for k, v in batch.items()}).items()}

    encdec = jcfg.family == "encdec"
    enc_sh = ns(port.input_layout(3).spec)
    with JL.use_mesh(jmesh, () if long_mode else ("data",)):
        p_sh = jax.tree.map(ns, api.param_pspecs(),
                            is_leaf=lambda x: isinstance(x, JP))
        prefill = jax.jit(api.prefill, in_shardings=(p_sh, in_sh(first),
                                                     c_sh),
                          out_shardings=(lg_sh, c_sh) + ((enc_sh,)
                                                         if encdec else ()))
        lg, caches, *enc = prefill(jp, first, caches)
        logits = [np.asarray(lg)]
        extra = {"enc_out": enc[0]} if encdec else {}
        d_sh = {**in_sh(steps[0]), **{k: enc_sh for k in extra}}
        decode = jax.jit(api.decode, in_shardings=(p_sh, d_sh, c_sh),
                         out_shardings=(lg_sh, c_sh))
        for batch in steps:
            lg, caches = decode(jp, {**batch, **extra}, caches)
            logits.append(np.asarray(lg))
    return logits, [np.asarray(a) for a in jax.tree.leaves(caches)]


def _unmeshed(name, mesh_shape, long_mode):
    """The port's unmeshed ``api.prefill`` / ``api.decode`` on each data
    shard's rows of the batch (the meshed step's MoE capacity is a
    shard's, as the reference's under ``shard_map``; the whole batch in
    long mode), the shards' logits and caches concatenated along the
    batch: (each step's logits, the final caches), in numpy."""
    d, m = mesh_shape
    jp, _ = _setup(name, m)
    cfg = _smoke(SMOKES, name)
    api = build(cfg, tp=m)
    params = api.params_from_numpy(jp, CPU)
    first, steps = _steps(name, long_mode)
    b = first["tokens"].shape[0]
    shards = 1 if long_mode else d
    seq = SEQ + cfg.num_patches
    logits, caches = [], []
    with torch.no_grad():
        for r in range(shards):
            rows = slice(r * b // shards, (r + 1) * b // shards)
            c = L.init_tree(api.cache_defs(b // shards, seq), 0, CPU)
            lg, c, *enc = api.prefill(params, {
                k: torch.from_numpy(v[rows]) for k, v in first.items()}, c)
            out = [lg]
            for batch in steps:
                inputs = {k: torch.from_numpy(v[rows])
                          for k, v in batch.items()}
                if enc:
                    inputs["enc_out"] = enc[0]
                lg, c = api.decode(params, inputs, c)
                out.append(lg)
            logits.append(out)
            caches.append(L.tree_leaves(c))
    leads = [g.lead for g in L.tree_leaves(cache_geometry(api))]
    return ([torch.cat(step).numpy() for step in zip(*logits)],
            [torch.cat(leaf, dim=lead).numpy()
             for leaf, lead in zip(zip(*caches), leads)])


def _hold(got, want, what):
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape, (what, i, a.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(a - w).max())
        assert err <= TOL * scale, (what, i, err, scale)




def hold_split_against_gathered(name, case):
    """Each step's logits (gathered from the slots' vocabulary blocks)
    and the caches (gathered from the slots' blocks) of the split step
    against the gathered step's on the same layouts."""
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode)
    lg_g, caches_g, _, _ = _outputs(name, mesh_shape, long_mode,
                                    split=False)
    _hold(lg, lg_g, (name, case, "logits"))
    _hold(caches, caches_g, (name, case, "caches"))


def hold_split_against_reference(name, case):
    """The split step's logits and caches against the reference's jit at
    the same shardings."""
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode)
    want_lg, want_caches = _reference(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))
