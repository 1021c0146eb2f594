"""Training on a mesh against the JAX reference, on the CPU, for the
recurrent and encoder-decoder families: 3 steps of
``Trainer(mesh=, zero1=)`` on 8 CPU slots against the reference's meshed
``Trainer`` on its 8 forced host devices (``_mesh_train.runs``: jamba's
and xlstm's recurrent mixers; seamless's encoder-decoder, with a
vocabulary of 500 too), with the tolerances of
``test_torch_mesh_train.py``."""
import pytest

from _mesh_train import ENCDEC, RECURRENT, hold_meshed_run, run_id, runs
from _torch_threads import one_torch_thread  # noqa: F401

RUNS = runs(RECURRENT + (ENCDEC,))


@pytest.mark.parametrize("name,mesh_shape,zero1", RUNS,
                         ids=[run_id(r) for r in RUNS])
def test_meshed_training_matches_the_reference(spmd_devices, tmp_path, name,
                                               mesh_shape, zero1):
    hold_meshed_run(tmp_path, name, mesh_shape, zero1)
