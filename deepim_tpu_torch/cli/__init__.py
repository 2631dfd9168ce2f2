"""Entry points of the port (``deepim_tpu/cli``).

``train``: the training driver (``python -m deepim_tpu_torch.cli.train``)
and ``load_assets_and_names``, with which the service builds its assets;
``test``: evaluation on the generated sets; ``train_test``: the two in a
row; ``track``: video tracking on generated or given sequences;
``convert_dataset``, ``validate_dataset`` and ``runbook``: a public
release converted, validated and evaluated.  Each runs on ``cuda:0``
unless ``--device`` says otherwise (the converters and the validator use
no device).
"""
