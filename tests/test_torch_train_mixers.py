"""The port's train step on the MoE, Mamba and RWKV architectures
(rwkv6-7b, deepseek-moe-16b, jamba-1.5-large, phi3.5-moe) at their
``reduced()`` size against the reference's, with the checks and
tolerances of `tests/test_torch_train.py` (which holds the dense, VLM
and audio architectures). A file of its own, so two test workers share
the reference's compiles."""
import pytest

from test_torch_train import (MIXER_ARCHS, check_gradients,
                              check_lm_loss_and_metrics,
                              check_reduced_train_step, check_remat_bits,
                              check_train_step)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_lm_loss_and_metrics_match_reference(arch):
    check_lm_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_gradients_match_jax_grad(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_reduced_train_step(arch):
    check_reduced_train_step(arch)


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    check_remat_bits(arch)
