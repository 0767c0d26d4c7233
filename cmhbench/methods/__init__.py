"""What the benchmark needs of each hashing method beside the shared CLIP
towers, one file a method, named after the configuration's ``method`` in
lower case (``dcmht.py`` for ``"method": "DCMHT"``):

- ``ARCH`` and ``RUNNER``: the port's registry names of its model and its
  trainer;
- ``head_leaves(cfg)``: its heads' tensors, as ``weights.py`` makes them
  from the seed, under the port's state-dict names;
- ``load_heads(model, heads)``: those tensors into the port's model;
- ``head_flops(cfg)``: both heads' forward FLOPs for one pair.

Its plain reference is ``reference/<the same name>.py``. A new method is
these two files and no edit of a file that is here.
"""
