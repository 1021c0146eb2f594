"""What the model-axis test modules share: the smokes by name, among
them the vocabulary-500 variants that take the row-parallel embedding
and logits, and a split train step's setup on a mesh of CPU slots.

A name "<arch>@v<N>" is <arch>'s smoke with a vocabulary of N
(``.replace(vocab_size=N)``, in either package's table).  500 divides
the model degrees 2 and 4 but not 8, so at (1, 8) the embedding table
(and an untied ``head``) is split along ``d_model``, as the reference's
``embed_defs`` falls back to where its model degree does not divide the
vocabulary; elsewhere it is split by vocabulary rows.

A name "<arch>@d<N>" is <arch>'s smoke with ``d_model`` N (and, where N
is not a multiple of its heads, gcd(heads, N) heads and KV heads).  66
gives the recurrent mixers an inner dim of 132 (Mamba's ``expand`` 2,
mLSTM's 2 d), which the model degrees 2 and 4 divide but 8 does not:
at (1, 8) the reference's specs leave ``di`` whole and the layer runs on
each data row's first slot; at degree 4 a slot holds 33 channels, half
of one of the two mLSTM heads."""
from math import gcd

import torch

from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train import trainer as T

CPU = "cpu"
# tied MLA, tied GQA, and phi3.5-moe's and seamless's untied heads split
# along d_model
ROW_PARALLEL = ("minicpm3-4b@v500", "llama3.2-3b@v500",
                "phi3.5-moe-42b-a6.6b@v500", "seamless-m4t-large-v2@v500")
# the recurrent mixers with an inner dim degree 8 does not divide
INNER_WHOLE = ("jamba-v0.1-52b@d66", "xlstm-125m@d66")


def smoke(table, name, dtype="float32"):
    """``name``'s smoke in ``table`` (the port's or the reference's), in
    ``dtype`` (None: the smoke's own)."""
    arch, _, width = name.partition("@d")
    arch, _, vocab = arch.partition("@v")
    cfg = table[arch]
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if width:
        d = int(width)
        h = gcd(cfg.num_heads, d)
        cfg = cfg.replace(d_model=d, num_heads=h,
                          num_kv_heads=min(cfg.num_kv_heads, h))
    return cfg.replace(vocab_size=int(vocab)) if vocab else cfg


def mesh_step(name, mesh_shape, seq, batch, zero1=False):
    """(api, mesh step, params laid out, opt state laid out, batch) of
    ``name``'s fp32 smoke on a mesh of CPU slots: ``batch`` sequences of
    ``seq`` text positions (after a VLM's patches), labels masked at
    three positions; every block its own storage, so a move can be told
    by the block it carries."""
    cfg = smoke(SMOKES, name)
    d, m = mesh_shape
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    api = build(cfg, tp=m)
    shape = ShapeConfig("t", "train", seq + cfg.num_patches, batch)
    with L.use_mesh(mesh):
        pspecs = api.param_pspecs()
        ospecs = O.opt_pspecs(api.param_defs(), zero1=zero1,
                              dp_axes=("data",), dp_size=d)
        parts = T.MeshStep(api, O.AdamWConfig(), mesh,
                           param_specs=pspecs, opt_specs=ospecs,
                           batch_specs=api.input_pspecs(shape))
    own = lambda laid: S.Laid(laid.layout, laid.shape,  # noqa: E731
                              [b.clone() for b in laid.blocks])
    params = api.init_params(0, CPU)
    laid = L.tree_map(own, S.lay_out_tree(params, S.layouts(mesh, pspecs)))
    opt = S.lay_out_tree(O.init_state(params), S.layouts(mesh, ospecs))
    g = torch.Generator().manual_seed(0)
    inputs = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                dtype=v.dtype)
                  if not v.dtype.is_floating_point else
                  torch.randn(v.shape, generator=g).to(v.dtype))
              for k, v in api.input_specs(shape).items()}
    inputs["labels"][0, :3] = -1
    return api, parts, laid, opt, inputs


def whole(laid):
    """The tensor of a ``sharded.Laid`` some of whose blocks are held."""
    coords = laid.layout.coords()
    out = torch.full(laid.shape, float("nan"))
    for j, b in enumerate(laid.blocks):
        if b is not None:
            out[laid.layout.block_slices(laid.shape, coords[j])] = b
    assert not torch.isnan(out).any()
    return out
