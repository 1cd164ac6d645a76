"""The plain reference that decides ``correct``.

A frozen copy of the port's plain PyTorch codecs as they stood at commit
f7198c601608a60bc7ae6d0f04e97bb0c9d94e2e (``texcomp_torch/core``,
``blocks/grid.py``, ``codecs/dxt.py``, ``codecs/etc.py``,
``codecs/pvrtc.py`` and the image-level rules of ``api/helper4x4.py`` and
``dist/pipeline.py``), and of the HQ DXT, HQ PVRTC and PVRTC 4bpp codecs as
they stood at commit f62647d2c9e2bdd0fb08dc8ace95be5a763be819
(``codecs/dxt_hq.py`` with the plain twin of
``ops/dxt_hq_cuda.cluster_topk4`` in ``dxt_hq.py``; ``codecs/pvrtc_hq.py``
and the decode of ``codecs/pvrtc.py`` in ``pvrtc_hq.py``;
``codecs/pvrtc4.py`` in ``pvrtc4.py``), cut to what
the benchmark's requests and cells encode. It imports torch and numpy
only: nothing of the port, of the JAX package or of JAX, so that a later
change to the port cannot move its own yardstick.
"""
