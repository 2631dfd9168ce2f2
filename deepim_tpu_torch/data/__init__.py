"""Pose sampling for refine inputs (torch).

Port of ``deepim_tpu/data/pairs.py`` (``sample_poses_in_frustum``,
``perturb_poses``).
"""
