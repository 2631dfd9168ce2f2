"""Evaluation: ADD(-S)/(5°, 5 cm)/Proj-2D/AUC tables and BOP export.

Port of ``deepim_tpu/eval`` (``evaluator.py``, ``bop_results.py``).
"""

from deepim_tpu_torch.eval.bop_results import HEADER, read_bop_csv, write_bop_csv
from deepim_tpu_torch.eval.evaluator import (
    PROPORTION_METRICS,
    EvalThresholds,
    ci_halfwidth,
    compute_pose_errors,
    evaluate_poses,
    format_table,
    macro_mean_halfwidth,
    wilson_ci,
)
