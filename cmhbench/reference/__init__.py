"""The plain reference the benchmark holds the port to.

Plain PyTorch in float32 with TF32 off: OpenAI's CLIP towers
(``clip.py``), the training step and BertAdam (``training.py``), each
method's heads and loss in a file named after it (``dcmht.py`` for
``"method": "DCMHT"``), the CLIP BPE tokenizer (``tokenizer.py``), and exact
Hamming top-k and the 4-direction mAP (``retrieval.py``). It imports nothing
of the port, of JAX or of the JAX package, and works out everything from
the benchmark's own inputs. The control, the reference in the precision
below bf16, runs every product of the towers in fp8 with per-tensor scales
(``clip.fp8_matmul``).

A method's file gives ``image_codes(P, image, mm)`` and ``text_codes(P,
text, mm)`` (its heads' eval outputs, ``P`` without the towers'
``backbone.`` prefix), ``bits(outputs)`` (±1 codes and each bit's margin)
and ``train_steps(P, batches, model, opt, t_total, mm, rows, chunk)``.
"""
