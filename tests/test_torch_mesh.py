"""The port's steps on a real mesh: DTensor parameters placed by the
sharding rules, on CPU ranks over gloo (`repro_torch.dist.ranks.run_ranks`
starts them; the rank program is `repro_torch.launch.mesh_cases`).

* A reduced qwen1.5-0.5b trains 3 steps on a 2×2 (data, model) mesh of
  four ranks from `input_specs`' placements (pure DP below 2e9
  parameters, FSDP over data), in float32, against the port's unsharded
  step from the same draws: losses at rtol 1e-5 (f32 sums of the batch
  shards' partial gradients in another order), parameters within
  3% of the most 3 AdamW steps at lr 3e-4 can move one (each step moves
  a parameter by about lr). The state saved and loaded back with
  ``load_checkpoint(shardings=)`` is the same DTensors, bit for bit.
* On a one-rank mesh the DTensor step in the variant's bf16 is the plain
  step bit for bit: losses and parameters.
* The serve step from `input_specs` on one rank and on 2×2: the
  ``cuda`` backend (``flash_decode`` on each rank's shards; on the CPU
  its plain version) gives the ``torch`` backend's logits, one
  flash_decode dispatch a layer a step; a sequence-sharded cache is
  refused on ``cuda``, naming its placement.
"""
import numpy as np
import pytest

from repro_torch.dist.ranks import run_ranks
from repro_torch.launch.mesh_cases import (max_rel_diff, mesh_decode_case,
                                           mesh_train_case)

ARCH = "qwen1_5_0_5b"
STEPS = 3
LR = 3e-4
TIMEOUT = 240.0


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mesh") / "ck")
    return run_ranks(mesh_train_case, 4,
                     args=(ARCH, 2, 2, 8, 32, STEPS, 0, "float32", "cpu",
                           ckpt), timeout=TIMEOUT)


def test_mesh_train_steps_match_the_unsharded_step(mesh_2x2):
    r = mesh_2x2[0]
    assert all(out == {} for out in mesh_2x2[1:])
    np.testing.assert_allclose(r["losses"], r["plain_losses"], rtol=1e-5)
    atol = 3e-2 * LR * STEPS
    for name, want in r["plain_params"].items():
        np.testing.assert_allclose(r["params"][name], want, rtol=0,
                                   atol=atol, err_msg=name)
    # the rules' placements: FSDP over data, replicated over model
    assert r["placements"]["slot0/wq"] == ["S(1)", "R"]
    assert r["placements"]["final_norm"] == ["R", "R"]


def test_load_checkpoint_places_each_leaf_on_the_mesh(mesh_2x2):
    assert mesh_2x2[0]["ckpt_equal"] is True


def test_one_rank_mesh_is_the_plain_step_bit_for_bit():
    r = run_ranks(mesh_train_case, 1, args=(ARCH, 1, 1, 8, 32, 2, 0, None,
                                            "cpu", None), timeout=TIMEOUT)[0]
    assert r["losses"] == r["plain_losses"]
    assert max_rel_diff(r["params"], r["plain_params"]) == 0.0


@pytest.mark.parametrize("world,grid", [(1, (1, 1)), (4, (2, 2))])
def test_mesh_decode_flash_decode_on_local_shards(world, grid):
    r = run_ranks(mesh_decode_case, world,
                  args=(ARCH, *grid, 4, 64, 3, 0, "cpu"),
                  timeout=TIMEOUT)[0]
    for got, want in r["logits"]:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    assert r["kernel_ok"] and r["finite"] and r["cdt"] == "bfloat16"
    assert r["launches"] == 2 * 3              # 2 attention layers, 3 steps
    assert "S(1)" in r["refused"] and "kv heads" in r["refused"]
