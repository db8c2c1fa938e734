"""The port's sharded train step for the SSM, recurrent and
encoder-decoder families against the JAX package's unsharded step, on the
CPU: reduced mamba2-780m, recurrentgemma-2b and seamless-m4t-large-v2 on a
(2, 2) mesh of a spawned gloo world of 4 ranks, and mamba2 with Adafactor
on (1, 4).  The world, the cases' inputs and the tolerances are
test_torch_sharded_step.py's (``run_cases``, ``check_case``): loss,
grad_norm and lr to 1e-5 relative, gradients to 1e-5 relative Frobenius
(5e-5 mamba2, 2e-5 griffin), updates to 1e-3 over the elements whose
gradients agree."""

import pytest

from test_torch_sharded_step import FAMILY_CASES, check_case, run_cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(FAMILY_CASES, tmp_path_factory.mktemp("sharded_families"))


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_sharded_family_step_matches_the_reference_unsharded_step(results, case):
    check_case(results, case)
