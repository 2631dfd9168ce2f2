"""Entry points of the port (``deepim_tpu/cli``).

``train``: the training driver (``python -m deepim_tpu_torch.cli.train``)
and ``load_assets_and_names``, with which the service builds its assets;
``test``: evaluation on the generated sets; ``train_test``: the two in a
row; ``track``: video tracking on generated or given sequences.  Each
runs on ``cuda:0`` unless ``--device`` says otherwise.
"""
