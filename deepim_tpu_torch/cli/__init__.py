"""Entry-point helpers of the port (``deepim_tpu/cli``).

Only ``train.load_assets_and_names`` is ported so far: the serving path
builds its render assets with it.  The train, test and track drivers are
ROADMAP A12-A13.
"""
