"""Traffic generators, one module a kind; each traffic mix is a JSON file of
parameters beside them that names its kind. A kind's module has
``setup(ctx)``, ``window(ctx)`` and ``check(ctx)`` (``hbbench.run.Context``)."""
