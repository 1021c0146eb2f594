"""Serving on the model axis (``launch/serve.py::MeshServe``) on 8 CPU
slots for the MoEs (phi3.5-moe, llama4-scout), the recurrent families
(jamba-v0.1-52b, xlstm-125m) and the encoder-decoder
(seamless-m4t-large-v2): the split prefill and decode steps against the
gathered step and against the reference's sharded jit at (1, 8), (2, 4)
and (4, 2) and in long mode at (2, 4) and (4, 2); the gathered step of
the recurrent families and the encoder-decoder against the unmeshed step
on each data shard's rows and the reference; and jamba's and xlstm's
inner-dim-132 variants, whose mixers run whole at degree 8.  Sizes and
tolerance as in ``test_torch_mesh_serve.py``, which holds the attention
families."""
import pytest

from repro_torch.train import sharded as S
from _mesh_serve import (CASES, SPLIT, _hold, _ids, _outputs, _reference,
                         _unmeshed, hold_split_against_gathered,
                         hold_split_against_reference)
from _model_axis import INNER_WHOLE
from _torch_threads import one_torch_thread  # noqa: F401

# the MoEs', the recurrent families' and the encoder-decoder's runs
MIXERS = SPLIT[4:]


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", MIXERS)
def test_split_serving_equals_the_gathered_step(name, case):
    """Each step's logits and the caches of the split step against the
    gathered step's on the same layouts."""
    hold_split_against_gathered(name, case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("name", MIXERS)
def test_split_serving_equals_the_references_sharded_jit(spmd_devices, name,
                                                         case):
    hold_split_against_reference(name, case)


# the gathered step (a data row's caches on its first slot, the whole
# parameters there) of the families whose caches are recurrent states or
# that return the encoder's output, on a model axis of one and of four,
# and the recurrent two in long mode
GATHERED = [(n, c) for n in ("jamba-v0.1-52b", "xlstm-125m")
            for c in (((8, 1), False), ((2, 4), False), ((2, 4), True))] \
    + [("seamless-m4t-large-v2", c) for c in (((8, 1), False),
                                              ((2, 4), False))]


@pytest.mark.parametrize("name,case", GATHERED,
                         ids=[f"{n}-{_ids(c)}" for n, c in GATHERED])
def test_the_gathered_step_serves_states_and_the_encoder(spmd_devices, name,
                                                          case):
    """Each cache leaf's batch dim read from its spec, not its rank: the
    recurrent states ((P, B, dc-1, di), (P, B, di, N), mLSTM's (P, B, nh,
    hd, hd) ...) gathered and written back whole for each data row, the
    encoder's output returned laid out at the inputs' spec and taken back
    by decode.  Each step's logits and every cache leaf against the
    unmeshed step on each data shard's rows and against the reference's
    sharded jit."""
    mesh_shape, long_mode = case
    lg, caches, _, _ = _outputs(name, mesh_shape, long_mode, split=False)
    want_lg, want_caches = _unmeshed(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))
    want_lg, want_caches = _reference(name, mesh_shape, long_mode)
    _hold(lg, want_lg, (name, case, "logits"))
    _hold(caches, want_caches, (name, case, "caches"))


@pytest.mark.parametrize("case", CASES[:3], ids=_ids)
@pytest.mark.parametrize("name", INNER_WHOLE)
def test_an_inner_dim_the_degree_does_not_divide_runs_whole(name, case):
    """jamba's and xlstm's smokes with an inner dim of 132: at (1, 8) the
    spec leaves ``di`` whole and the Mamba and mLSTM layers run on each
    data row's first slot, their states replicated over the model slots;
    at (2, 4) and (4, 2) they split.  Split against gathered."""
    hold_split_against_gathered(name, case)
    _, _, serve, _ = _outputs(name, *case)
    mixer = serve.p_specs["stack"][0]["mixer"]
    w = mixer["in_proj" if "in_proj" in mixer else "up_proj"]
    assert (S.model_dim(w) is None) == (case[0][1] == 8)
