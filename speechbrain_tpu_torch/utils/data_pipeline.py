"""Dynamic-item data pipeline: a DAG of per-example transforms.

Functions are declared with ``@takes`` / ``@provides`` and composed into a
``DataPipeline``; when output keys are requested, only the transitively
needed items are computed, in topological order.  This runs on the HOST
(feeding the device input pipeline) and is deliberately framework-free
Python — the device boundary is downstream, at batch collation.

A copy of ``speechbrain_tpu/utils/data_pipeline.py`` (the port imports
nothing of the JAX package).

Example
-------
>>> pipeline = DataPipeline(
...     static_data_keys=["text"],
...     dynamic_items=[
...         {"func": lambda t: t.lower(), "takes": ["text"], "provides": "lower"},
...         {"func": lambda t: t[::-1], "takes": ["lower"], "provides": "reversed"},
...     ],
...     output_keys=["reversed"],
... )
>>> pipeline({"text": "Example"})
{'reversed': 'elpmaxe'}
"""

import inspect

from .depgraph import DependencyGraph

__all__ = [
    "takes",
    "provides",
    "DynamicItem",
    "GeneratorDynamicItem",
    "DataPipeline",
]


class DynamicItem:
    """A data transform with declared inputs (takes) and outputs (provides)."""

    def __init__(self, takes=None, func=None, provides=None):
        self.takes = list(takes) if takes else []
        self.func = func
        self.provides = list(provides) if provides else []

    def __call__(self, *args):
        return self.func(*args)

    def next_takes(self):
        """Keys this item consumes."""
        return self.takes

    def next_provides(self):
        """Keys this item provides."""
        return self.provides

    def provided_in_order(self):
        """List of output-key lists, one per evaluation step (single here)."""
        return [self.provides]

    def reset(self):
        """Reset iteration state."""
        pass


class GeneratorDynamicItem(DynamicItem):
    """Multi-output transform implemented as a generator.

    Each ``yield`` produces the next chunk of ``provides``; intermediate
    state lives in the suspended generator frame, so expensive early work
    (e.g. audio decode) is shared between the outputs without recompute.
    """

    def __init__(self, takes=None, func=None, provides=None):
        super().__init__(takes, func, provides)
        self.current_generator = None
        self.num_provided_items = 0

    def __call__(self, *args):
        if self.current_generator is None:
            self.current_generator = self.func(*args)
        out = next(self.current_generator)
        self.num_provided_items += 1
        return out

    def next_takes(self):
        """Keys this item consumes."""
        # Arguments are consumed only when the generator is created.
        if self.current_generator is None:
            return self.takes
        return []

    def next_provides(self):
        """Keys this item provides."""
        keys = self.provides[self.num_provided_items]
        if isinstance(keys, str):
            return [keys]
        return list(keys)

    def provided_in_order(self):
        """Provided-key groups in generator yield order."""
        out = []
        for keys in self.provides:
            if isinstance(keys, str):
                out.append([keys])
            else:
                out.append(list(keys))
        return out

    def reset(self):
        """Reset iteration state."""
        if self.current_generator is not None:
            self.current_generator.close()
        self.current_generator = None
        self.num_provided_items = 0


def takes(*argkeys):
    """Decorator declaring the input keys of a dynamic item."""

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            if obj.takes:
                raise ValueError("Can't overwrite DynamicItem.takes")
            obj.takes = list(argkeys)
            return obj
        elif inspect.isgeneratorfunction(obj):
            return GeneratorDynamicItem(takes=list(argkeys), func=obj)
        else:
            return DynamicItem(takes=list(argkeys), func=obj)

    return decorator


def provides(*output_keys):
    """Decorator declaring the output keys of a dynamic item.

    On a generator function, each positional key (or tuple of keys)
    corresponds to one ``yield``.
    """

    def decorator(obj):
        if isinstance(obj, DynamicItem):
            if obj.provides:
                raise ValueError("Can't overwrite DynamicItem.provides")
            obj.provides = list(output_keys)
            return obj
        elif inspect.isgeneratorfunction(obj):
            return GeneratorDynamicItem(func=obj, provides=list(output_keys))
        else:
            return DynamicItem(func=obj, provides=list(output_keys))

    return decorator


class StaticItem:
    """Marker node for a key expected to exist in the raw data dict."""

    def __init__(self, key):
        self.key = key


class DataPipeline:
    """Computes requested output keys from static data + dynamic items."""

    def __init__(self, static_data_keys, dynamic_items=(), output_keys=()):
        self.dg = DependencyGraph()
        self._exec_order = None
        self.key_to_node = {}
        self.unaccounted_keys = {}
        self.dynamic_items = []
        self.output_mapping = {}
        self.add_static_keys(static_data_keys)
        self.add_dynamic_items(dynamic_items)
        self.set_output_keys(output_keys)

    def add_static_keys(self, static_keys):
        """Declare keys that exist in the raw data dict."""
        for key in static_keys:
            node_id = self.dg.add_node(data=StaticItem(key=key))
            self.key_to_node[key] = node_id

    def add_dynamic_items(self, dynamic_items):
        """Add several dynamic items at once."""
        for item in dynamic_items:
            if isinstance(item, dict):
                self.add_dynamic_item(**item)
            else:
                self.add_dynamic_item(item)

    def add_dynamic_item(self, func, takes=None, provides=None):
        """Add one transform.

        ``func`` may already be a ``DynamicItem`` (decorated), in which case
        ``takes``/``provides`` must not be given again.
        """
        if isinstance(func, DynamicItem):
            if takes is not None or provides is not None:
                raise ValueError(
                    "If providing a DynamicItem directly, don't pass takes/provides"
                )
            self._add_dynamic_item_object(func)
            return
        if isinstance(takes, str):
            takes = [takes]
        if isinstance(provides, str):
            provides = [provides]
        if inspect.isgeneratorfunction(func):
            di = GeneratorDynamicItem(takes=list(takes), func=func, provides=list(provides))
        else:
            di = DynamicItem(takes=list(takes), func=func, provides=list(provides))
        self._add_dynamic_item_object(di)

    def _add_dynamic_item_object(self, obj):
        if not obj.provides:
            raise ValueError("Dynamic item must provide output keys")
        for depended in obj.takes:
            if depended not in self.key_to_node:
                dependee_keys = self.unaccounted_keys.setdefault(depended, [])
                dependee_keys.extend(obj.provided_in_order()[0])
        for provided_keys in obj.provided_in_order():
            node_id = self.dg.add_node(data=obj)
            for key in provided_keys:
                if key in self.key_to_node:
                    raise ValueError(f"Duplicate provided key: {key}")
                self.key_to_node[key] = node_id
                # Resolve forward references:
                if key in self.unaccounted_keys:
                    for dependee_key in self.unaccounted_keys[key]:
                        dependee_node = self.key_to_node[dependee_key]
                        self.dg.add_edge(dependee_node, node_id)
                    del self.unaccounted_keys[key]
        # Add backward edges (may span multiple generator steps):
        prev_node = None
        for provided_keys in obj.provided_in_order():
            node_id = self.key_to_node[provided_keys[0]]
            for depended in obj.takes:
                if depended in self.key_to_node:
                    self.dg.add_edge(node_id, self.key_to_node[depended])
            if prev_node is not None:
                self.dg.add_edge(node_id, prev_node)
            prev_node = node_id
        self.dynamic_items.append(obj)
        self._exec_order = None

    def set_output_keys(self, keys):
        """Set which keys ``compute_outputs`` returns.

        A dict maps from output name -> internal key (renaming on output).
        """
        self.output_mapping = self._output_keys_to_mapping(keys)
        self._exec_order = None

    @staticmethod
    def _output_keys_to_mapping(keys):
        if keys is None:
            return {}
        if isinstance(keys, dict):
            return dict(keys)
        return {key: key for key in keys}

    def compute_outputs(self, data):
        """Compute the requested output keys for one example dict."""
        if self._exec_order is None:
            self._prepare_run(data)
        return self._compute(data, self._exec_order, self.output_mapping)

    def compute_specific(self, keys, data):
        """Compute an ad-hoc set of keys (not the configured outputs)."""
        output_mapping = self._output_keys_to_mapping(keys)
        order = self.dg.get_evaluation_order(
            selected_keys=self.get_selected_node_ids(keys)
        )
        return self._compute(data, order, output_mapping)

    def _compute(self, data, order, output_mapping):
        if self.unaccounted_keys:
            raise RuntimeError(
                f"Dynamic items depend on unknown keys: {list(self.unaccounted_keys)}"
            )
        intermediate = {}
        for node_id, edges, item in order:
            if isinstance(item, StaticItem):
                try:
                    intermediate[item.key] = data[item.key]
                    continue
                except KeyError:
                    raise KeyError(f"Expected key {item.key} in data, not found")
            args = [
                intermediate[argkey] if argkey in intermediate else data[argkey]
                for argkey in item.next_takes()
            ]
            provided_keys = item.next_provides()
            values = item(*args)
            if len(provided_keys) == 1:
                values = [values]
            intermediate.update(zip(provided_keys, values))
        for item in self.dynamic_items:
            item.reset()
        return {
            outkey: intermediate[inkey]
            for outkey, inkey in output_mapping.items()
        }

    def get_selected_node_ids(self, selected_keys):
        """Dependency-ordered node ids computing the given keys."""
        return [self.key_to_node[key] for key in selected_keys]

    def _prepare_run(self, data):
        self._exec_order = list(
            self.dg.get_evaluation_order(
                self.get_selected_node_ids(self.output_mapping.values())
            )
        )

    def __call__(self, data):
        return self.compute_outputs(data)
