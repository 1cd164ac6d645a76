"""The plain reference that decides ``correct``.

A frozen copy of the port's plain PyTorch codecs as they stood at commit
f7198c601608a60bc7ae6d0f04e97bb0c9d94e2e (``texcomp_torch/core``,
``blocks/grid.py``, ``codecs/dxt.py``, ``codecs/etc.py``,
``codecs/pvrtc.py`` and the image-level rules of ``api/helper4x4.py`` and
``dist/pipeline.py``), cut to what the benchmark's cells encode. It
imports torch and numpy only: nothing of the port, of the JAX package or
of JAX, so that a later change to the port cannot move its own yardstick.
"""
