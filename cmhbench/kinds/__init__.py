"""One module a kind of traffic (a traffic file's ``kind``): ``train``,
``search`` and ``valid``. Each takes a ``common.Context`` and returns a
``common.Outcome``; what is shared between them is in ``program.py``."""
