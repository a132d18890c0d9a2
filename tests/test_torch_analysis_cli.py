"""The cases of ``tests/test_analysis.py`` that run the lint gate's CLI,
once on each package (``tests/torch_twins.py``): the port's twin runs
``python -m containerpilot_tpu_torch.analysis`` over the port's tree.
Each run scans a whole package, so these stand apart from the
in-process cases of ``tests/test_torch_analysis.py``."""
import pytest

import torch_twins
from test_torch_analysis import load_twins, reference_cases

CASES = reference_cases(cli=True)


@pytest.fixture(scope="module")
def twins():
    return load_twins()


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("case", CASES)
def test_analysis_cli_case(case, package, twins, tmp_path):
    fn = getattr(twins[package], case)
    fn(**torch_twins.case_args(fn, {"tmp_path": tmp_path}))
