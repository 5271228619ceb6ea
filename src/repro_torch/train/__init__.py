"""Training substrate (``repro/train``): sessions and schedules (LDA),
the LM train step, optimizers, checkpointing in the reference's format,
and the fault-tolerant loop.

Re-exports are lazy (PEP 562) so importing one corner, e.g.
``repro_torch.train.session``, never pulls the LM model stack in.
"""
_EXPORTS = {
    "RunConfig": ("repro_torch.train.session", "RunConfig"),
    "TrainSession": ("repro_torch.train.session", "TrainSession"),
    "StreamingSession": ("repro_torch.train.online", "StreamingSession"),
    "Schedule": ("repro_torch.train.schedule", "Schedule"),
    "ScheduledAction": ("repro_torch.train.schedule", "ScheduledAction"),
    "adafactor_init": ("repro_torch.train.optimizer", "adafactor_init"),
    "adafactor_update": ("repro_torch.train.optimizer", "adafactor_update"),
    "adamw_init": ("repro_torch.train.optimizer", "adamw_init"),
    "adamw_update": ("repro_torch.train.optimizer", "adamw_update"),
    "make_optimizer": ("repro_torch.train.optimizer", "make_optimizer"),
    "make_train_step": ("repro_torch.train.train_step", "make_train_step"),
    "TrainState": ("repro_torch.train.train_step", "TrainState"),
}


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(_EXPORTS)
