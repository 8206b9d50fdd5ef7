"""One module a model family, found by the ``family`` key of a
configuration file (``harness.family_module``): everything of the model
that the harness reaches, behind one interface (``benchmark/README.md``,
"A model family")."""
