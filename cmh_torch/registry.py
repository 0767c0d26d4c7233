"""Global name→class registry (a copy of ``cmh_tpu/registry.py``).

Named maps for datasets / models / optimizers / tokenizers / runners plus a
generic dotted-path state store and path registry. Duplicate registrations
raise ``KeyError``; lookups of unknown names return ``None``; the
``require_*`` lookups raise a ``KeyError`` that lists what is registered,
which in the port is what is ported: the ``DCMHT``, ``Baseline``, ``DSPH``,
``DNPH``, ``MITH``, ``TwDH``, ``DIMCH`` and ``UMoED`` models and their
``*Trainer`` runners, the
``synthetic_dataset`` and ``transformer_dataset`` datasets and the
``clip_tokenizer``. ``load_components`` imports the
modules that register them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """Name→class maps with decorator-based registration."""

    def __init__(self) -> None:
        self.mapping: Dict[str, Dict[str, Any]] = {
            "dataset_name_mapping": {},
            "model_name_mapping": {},
            "runner_name_mapping": {},
            "optimizer_name_mapping": {},
            "tokenizer": {},
            "state": {},
            "paths": {},
        }

    # ---------------------------------------------------------------- helpers
    def _register(self, table: str, name: str) -> Callable:
        def wrap(cls):
            if name in self.mapping[table]:
                raise KeyError(
                    "Name '{}' already registered for {}.".format(
                        name, self.mapping[table][name]
                    )
                )
            self.mapping[table][name] = cls
            return cls

        return wrap

    # ------------------------------------------------------------- decorators
    def register_dataset(self, name: str) -> Callable:
        return self._register("dataset_name_mapping", name)

    def register_model(self, name: str) -> Callable:
        return self._register("model_name_mapping", name)

    def register_optimizer(self, name: str) -> Callable:
        return self._register("optimizer_name_mapping", name)

    def register_tokenizer(self, name: str) -> Callable:
        return self._register("tokenizer", name)

    def register_runner(self, name: str) -> Callable:
        return self._register("runner_name_mapping", name)

    def register_path(self, name: str, path: str) -> None:
        assert isinstance(path, str), "All path must be str."
        if name in self.mapping["paths"]:
            raise KeyError("Name '{}' already registered.".format(name))
        self.mapping["paths"][name] = path

    # ------------------------------------------------------ generic state API
    def register(self, name: str, obj: Any) -> None:
        """Store ``obj`` under a dotted path in the state store."""
        path = name.split(".")
        current = self.mapping["state"]
        for part in path[:-1]:
            current = current.setdefault(part, {})
        current[path[-1]] = obj

    def get(self, name: str, default: Any = None, no_warning: bool = False) -> Any:
        value: Any = self.mapping["state"]
        for part in name.split("."):
            if not isinstance(value, dict):
                return default
            value = value.get(part, default)
            if value is default:
                break
        return value

    def unregister(self, name: str) -> Any:
        return self.mapping["state"].pop(name, None)

    # ----------------------------------------------------------------- lookup
    def get_dataset_class(self, name: str) -> Optional[type]:
        return self.mapping["dataset_name_mapping"].get(name, None)

    def get_model_class(self, name: str) -> Optional[type]:
        return self.mapping["model_name_mapping"].get(name, None)

    def get_optimizer_class(self, name: str) -> Optional[type]:
        return self.mapping["optimizer_name_mapping"].get(name, None)

    def get_tokenizer_class(self, name: str) -> Optional[type]:
        return self.mapping["tokenizer"].get(name, None)

    def get_runner_class(self, name: str) -> Optional[type]:
        return self.mapping["runner_name_mapping"].get(name, None)

    def get_path(self, name: str) -> Optional[str]:
        return self.mapping["paths"].get(name, None)

    # ------------------------------------------------------- strict lookup
    def _require(self, table: str, kind: str, name: str) -> type:
        cls = self.mapping[table].get(name, None)
        if cls is None:
            raise KeyError(
                "unknown {} '{}'; registered: {}".format(
                    kind, name, ", ".join(sorted(self.mapping[table])) or "<none>"
                )
            )
        return cls

    def require_dataset_class(self, name: str) -> type:
        return self._require("dataset_name_mapping", "dataset arch", name)

    def require_model_class(self, name: str) -> type:
        return self._require("model_name_mapping", "model arch", name)

    def require_optimizer_class(self, name: str) -> type:
        return self._require("optimizer_name_mapping", "optimizer arch", name)

    def require_tokenizer_class(self, name: str) -> type:
        return self._require("tokenizer", "tokenizer", name)

    def require_runner_class(self, name: str) -> type:
        return self._require("runner_name_mapping", "runner arch", name)

    # ------------------------------------------------------------------ lists
    def list_runners(self):
        return sorted(self.mapping["runner_name_mapping"].keys())

    def list_models(self):
        return sorted(self.mapping["model_name_mapping"].keys())

    def list_datasets(self):
        return sorted(self.mapping["dataset_name_mapping"].keys())

    def list_optimizer(self):
        return sorted(self.mapping["optimizer_name_mapping"].keys())


registry = Registry()


def load_components() -> Registry:
    """Import every module that registers a component; returns the registry."""
    from .data import dataset  # noqa: F401
    from .models import baseline, dcmht, dimch, dnph, dsph, mith, twdh, umoed  # noqa: F401
    from .models.clip import tokenizer  # noqa: F401
    from .runners import baseline as _r1, dcmht as _r2, dnph as _r3, dsph as _r4  # noqa: F401
    from .runners import dimch as _r5, mith as _r6, twdh as _r7, umoed as _r8  # noqa: F401

    return registry
