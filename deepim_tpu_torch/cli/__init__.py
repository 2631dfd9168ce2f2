"""Entry points of the port (``deepim_tpu/cli``).

``train``: the training driver (``python -m deepim_tpu_torch.cli.train``)
and ``load_assets_and_names``, with which the service builds its assets.
The test and track drivers are ROADMAP A13.
"""
