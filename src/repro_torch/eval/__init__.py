"""Model-quality evaluation (``repro/eval``), counted on the card.

* ``coherence`` — UMass and sliding-window NPMI topic coherence over the
  top-N words per topic, from exact corpus co-occurrence integers counted
  with tensor operations on the corpus's device.
* ``left_to_right`` — Wallach-style particle left-to-right held-out
  log-likelihood, many documents swept together on the model's device,
  from the reference's numpy uniform streams; ``exhaustive_llh`` is the
  enumeration oracle.
* ``quality`` — ``QualityConfig``/``QualityEval``: the evaluator the
  ``TrainSession`` "quality" schedule action fires.
"""
from repro_torch.eval.coherence import (  # noqa: F401
    CoherenceStats,
    npmi_coherence,
    top_topic_words,
    umass_coherence,
)
from repro_torch.eval.left_to_right import (  # noqa: F401
    exhaustive_llh,
    left_to_right_llh,
    left_to_right_llh_batch,
)
from repro_torch.eval.quality import QualityConfig, QualityEval  # noqa: F401
