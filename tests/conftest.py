"""Test harness: force an 8-device virtual CPU mesh before JAX initialises.

This is the JAX idiom for exercising SPMD/multi-chip code paths without real
hardware (SURVEY.md §4); bench.py and production entry points run on the real
TPU instead.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# A site plugin may force a hardware platform list after env parsing; pin CPU
# explicitly so tests never touch the real chip.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) >= 8, "virtual device mesh not active"


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ---------------------------------------------------------------------------
# Fast/slow tiers (round-3 VERDICT #7). The slow tier is the interpret-mode
# Pallas kernels, full-stack oracles and multi-step train/GAN tests — ~1,880
# of the suite's ~2,100 s on this single-core host (measured --durations=60,
# 2026-08-20). Default run: ~4 min. `--slow` restores the full suite; no
# test is deleted. Maintained as one nodeid set here (single source) instead
# of scattered decorators; anything not listed runs in the default tier.
# The adopted serving kernels keep a cheap bit-exact guard in the FAST tier
# (tests/test_kernel_smoke.py, ADVICE r3) — run `pytest --slow` for the full
# kernel suite after touching posetpu/ops/pallas/ or posetpu/serving.py.
# ---------------------------------------------------------------------------
SLOW_TESTS = {
    "test_train_step.py::test_graft_entry_dryrun",
    "test_train_step.py::test_graft_entry_forward_compiles",
    "test_train_step.py::test_train_step_sharded_matches_single_device",
    "test_train_step.py::test_eval_step_sharded_matches_single_device",
    "test_train_step.py::test_train_step_runs_and_decreases_mse",
    "test_train_step.py::test_watch_grad_norm_emits_metrics",
    "test_train_step.py::test_train_step_with_all_deterministic_losses",
    "test_train_step.py::test_fix_backbone_only_updates_aggregation",
    "test_train_step.py::test_checkpoint_async_save_roundtrip",
    "test_train_step.py::test_eval_step_with_flip",
    "test_gan.py::test_adversarial_step_both_parities",
    "test_gan.py::test_adversarial_step_watch_grad_norm",
    "test_gan.py::test_local_mi_joint_variant",
    "test_gan.py::test_domain_gan_drives_discriminator_accuracy",
    "test_integration.py::test_cli_train_end_to_end_sharded",
    "test_integration.py::test_int8_quant_eval_step_in_validate_loop",
    "test_integration.py::test_cli_validate_trainset_grouping_matches_pseudo_labels",
    "test_phase_kernel.py::test_phase_kernel_bitexact_vs_xla_phase_tail",
    "test_phase_kernel.py::test_phase_tail2_bitexact_vs_xla_phase_tail",
    "test_phase_kernel.py::test_subpixel_deconv_kernel_bitexact_vs_xla_subpixel",
    "test_phase_kernel.py::test_subpixel_deconv_kernel_batched_bitexact",
    "test_qat.py::test_qat_reduces_quantization_error",
    "test_qat.py::test_fake_quant_matches_int8_runner",
    "test_rpsm.py::test_rpsm_refines_to_gt",
    "test_tail_jns.py::test_jns_tail_matches_nhwc_tail",
    "test_serving.py::test_serving_preds_match_jns_reference",
    "test_serving.py::test_serving_flip_test_and_defaults_smoke",
    "test_serving.py::test_serving_premirrored_flip_matches_device_mirror",
    "test_phase_tail.py::test_s2d_stem_bitexact",
    "test_phase_tail.py::test_phase_forward_bitexact_vs_jns",
    "test_phase_tail.py::test_per_name_subpixel_deconv",
    "test_quant.py::test_int8_subpixel_variant_matches",
    "test_pseudo.py::test_mint_choose_policy",
}


def pytest_addoption(parser):
    parser.addoption("--slow", action="store_true", default=False,
                     help="also run the slow tier (full suite)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: interpret-mode Pallas / full-oracle / multi-step "
        "tests, skipped by default (enable with --slow)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA (the port's hand-written "
        "kernels); skips where torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = f"{os.path.basename(item.fspath)}::{item.name.split('[')[0]}"
        if base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow tier (run with --slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
