"""Image ops of the refine loop: the zoom crop and its resampler (torch).

Port of ``deepim_tpu/ops`` (``zoom.py``, ``resample.py``).
"""
