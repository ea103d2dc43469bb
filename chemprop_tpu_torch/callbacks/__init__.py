"""Prediction-time callbacks (cf. ``chemprop_tpu/callbacks/__init__.py``): a
callback's ``explain(model, dataset)`` runs an explainer of
:mod:`chemprop_tpu_torch.interpret` over every molecule of a dataset, as the
``predict`` command line's ``--callback`` does. The port's model carries its
weights, so no ``variables`` argument is taken; the explainer's keyword
arguments (``device``, ``graphs_per_batch``, ...) pass through."""

from __future__ import annotations

from chemprop_tpu_torch.interpret import (
    MCTSRationaleExplainer,
    MyersonExplainer,
    check_explainable,
)
from chemprop_tpu_torch.utils.registry import ClassRegistry

CallbackRegistry = ClassRegistry()


@CallbackRegistry.register("myerson")
class MyersonExplainerCallback:
    """Per-atom Myerson-value attributions: exact enumeration for molecules
    with <= ``sampling_threshold`` atoms, Monte-Carlo sampling above it; the
    command line saves them as ``.npz`` (or ``.json``)."""

    def __init__(self, sampling_threshold: int = 20, n_samples: int = 200,
                 save_as_json: bool = False, seed: int = 0, **kwargs):
        self.sampling_threshold = sampling_threshold
        self.n_samples = n_samples
        self.save_as_json = save_as_json
        self.seed = seed
        self.kwargs = kwargs

    def explain(self, model, dataset):
        check_explainable(model)
        explainer = MyersonExplainer(
            model,
            sampling_threshold=self.sampling_threshold,
            n_samples=self.n_samples,
            seed=self.seed,
            **self.kwargs,
        )
        return [explainer.explain(dataset[i].mg) for i in range(len(dataset))]


@CallbackRegistry.register("mcts")
class MCTSRationaleCallback:
    """MCTS substructure rationales (:class:`MCTSRationaleExplainer`), over
    the graphs of the dataset's own featurizer (the JAX package's callback
    takes the default one whatever the dataset's)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def explain(self, model, dataset):
        check_explainable(model)
        kwargs = {"featurizer": dataset.featurizer, **self.kwargs}
        explainer = MCTSRationaleExplainer(model, **kwargs)
        return [explainer.explain_mol(dataset.data[i].mol) for i in range(len(dataset))]


__all__ = ["CallbackRegistry", "MCTSRationaleCallback", "MyersonExplainerCallback"]
