"""Runners: ``runners/<name>.py`` drives one kind of cell; a
configuration names its runner (``"runner"``). A runner module defines
``Runner(config, traffic, cell, seed, device)`` with ``build(parts)``
and ``warm_up(parts)`` (set-up), ``window(seconds, mark)``, ``shape()``,
``release()`` and ``check()``; see ``lda_train``."""
