"""PyTorch + CUDA port of ``deepim_tpu`` for NVIDIA Hopper (H100).

The JAX package ``deepim_tpu`` is the reference; this package mirrors its
subpackages and function names so each counterpart is easy to find.  It
imports ``torch`` and numpy only (never jax), computes on the device of its
inputs, and draws random numbers from explicit ``torch.Generator``s.

Ported so far: the inference refine loop
(:func:`deepim_tpu_torch.refine.refine_poses`: render -> zoom -> FlowNetS
pose head -> untangled SE(3) compose), on untextured and textured assets;
the multi-object scene render (:func:`deepim_tpu_torch.refine.render_scene`)
and on-device pair synthesis (:mod:`deepim_tpu_torch.data.synthetic`); and
the renderer's entry points with every binning route, face chunking and
the deferred-texture pass; multi-hypothesis selection
(:func:`deepim_tpu_torch.refine.refine_multi_hypothesis`, its
:func:`~deepim_tpu_torch.refine.score_poses`) and video tracking
(:func:`deepim_tpu_torch.refine.refine_video`); and the serving path:
:class:`deepim_tpu_torch.serve.PoseRefinerService` with the config
(:func:`deepim_tpu_torch.config.config_from_dict`), the asset loader, the
model builder and torch checkpoints that carry weights trained by the
JAX package; and training: the flow decoder and mask head, the losses
(:mod:`deepim_tpu_torch.losses`), flow ground truth, the optimizer and the
fused synthesize-and-train step (:mod:`deepim_tpu_torch.train`) driven by
``python -m deepim_tpu_torch.cli.train``; and evaluation: the ADD(-S)/(5°,
5 cm)/Proj-2D evaluator with its Wilson intervals and the BOP export
(:mod:`deepim_tpu_torch.eval`), ``python -m deepim_tpu_torch.cli.test`` on
the generated sets, ``cli.train_test``, and the video toolkit
(:mod:`deepim_tpu_torch.data.video`: sequences written with the port's
own PNG codec, ``gen_video`` with its manifest) with ``cli.track``; and
the host runtime (:mod:`deepim_tpu_torch.native`: its own copy of the
reference's C++ for mesh parsing, vertex normals, decimation, PNG decoding
and the prefetch reader, routed where the reference routes it) with the
protocol tools (:mod:`deepim_tpu_torch.tools`); and several ranks
(:mod:`deepim_tpu_torch.parallel`: process groups, rank meshes, the
gradient all-reduce, the pose head's tensor parallelism; ``--n-devices``
and ``torchrun`` on the drivers; ``dryrun_multichip``).  All three rasterizer
kernels are hand-written CUDA (``raster/csrc``), built at first use on the
card.
"""
