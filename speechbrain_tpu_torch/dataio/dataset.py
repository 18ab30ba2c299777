"""DynamicItemDataset: map-style dataset over manifest dicts + pipeline.

A copy of ``speechbrain_tpu/dataio/dataset.py`` (the port imports
nothing of the JAX package): ``DynamicItemDataset`` with
``from_json``/``from_csv``, ``filtered_sorted`` and
``FilteredSortedDynamicItemDataset`` (``from_arrow_dataset`` and the
module's helpers over several datasets are not ported).

Example
-------
>>> data = {
...     "u1": {"text": "hello world", "duration": 2.0},
...     "u2": {"text": "how are you", "duration": 3.0},
... }
>>> ds = DynamicItemDataset(data)
>>> ds.add_dynamic_item(lambda t: t.split(), takes="text", provides="words")
>>> ds.set_output_keys(["id", "words"])
>>> ds[0]["words"]
['hello', 'world']
"""

import contextlib
import copy
import logging

from .dataio import load_data_csv, load_data_json
from ..utils.data_pipeline import DataPipeline

logger = logging.getLogger(__name__)

__all__ = ["DynamicItemDataset", "FilteredSortedDynamicItemDataset"]


class DynamicItemDataset:
    """Dataset mapping integer indices to pipeline-computed example dicts."""

    def __init__(self, data, dynamic_items=[], output_keys=[]):
        self.data = data
        self.data_ids = list(self.data.keys())
        static_keys = list(self.data[self.data_ids[0]].keys())
        if "id" in static_keys:
            raise ValueError("The key 'id' is reserved for the data point id.")
        static_keys.append("id")
        self.pipeline = DataPipeline(static_keys, dynamic_items, output_keys)

    def __len__(self):
        return len(self.data_ids)

    def __getitem__(self, index):
        data_id = self.data_ids[index]
        data_point = self.data[data_id]
        return self.pipeline.compute_outputs({"id": data_id, **data_point})

    def add_dynamic_item(self, func, takes=None, provides=None):
        """Make a new dynamic item available on the dataset."""
        self.pipeline.add_dynamic_item(func, takes, provides)

    def set_output_keys(self, keys):
        """Use these keys in the output dict (see DataPipeline)."""
        self.pipeline.set_output_keys(keys)

    @contextlib.contextmanager
    def output_keys_as(self, keys):
        """Temporarily change output keys (not thread-safe)."""
        saved_output = self.pipeline.output_mapping
        self.pipeline.set_output_keys(keys)
        yield self
        self.pipeline.output_mapping = saved_output
        self.pipeline._exec_order = None

    def filtered_sorted(
        self,
        key_min_value={},
        key_max_value={},
        key_test={},
        sort_key=None,
        reverse=False,
        select_n=None,
    ):
        """A filtered and/or sorted view of self, as a new dataset.

        Temporarily computes only the keys needed for filtering/sorting.
        """
        filtered_sorted_ids = self._filtered_sorted_ids(
            key_min_value, key_max_value, key_test, sort_key, reverse, select_n
        )
        return FilteredSortedDynamicItemDataset(self, filtered_sorted_ids)

    def _filtered_sorted_ids(
        self,
        key_min_value={},
        key_max_value={},
        key_test={},
        sort_key=None,
        reverse=False,
        select_n=None,
    ):
        def combined_filter(computed):
            for key, limit in key_min_value.items():
                if computed[key] >= limit:
                    continue
                return False
            for key, limit in key_max_value.items():
                if computed[key] <= limit:
                    continue
                return False
            for key, func in key_test.items():
                if bool(func(computed[key])):
                    continue
                return False
            return True

        temp_keys = (
            set(key_min_value.keys())
            | set(key_max_value.keys())
            | set(key_test.keys())
            | ({sort_key} if sort_key is not None else set())
        )
        filtered_ids = []
        with self.output_keys_as(temp_keys):
            for i, data_id in enumerate(self.data_ids):
                data_point = self.data[data_id]
                computed = self.pipeline.compute_outputs(
                    {"id": data_id, **data_point}
                )
                if combined_filter(computed):
                    if sort_key is not None:
                        filtered_ids.append(
                            (computed[sort_key], i, data_id)
                        )
                    else:
                        filtered_ids.append((i, i, data_id))
                if select_n is not None and sort_key is None and len(filtered_ids) == select_n:
                    break
        filtered_sorted_ids = [
            tup[2] for tup in sorted(filtered_ids, reverse=reverse)
        ]
        if select_n is not None:
            filtered_sorted_ids = filtered_sorted_ids[:select_n]
        return filtered_sorted_ids

    @classmethod
    def from_json(
        cls, json_path, replacements={}, dynamic_items=[], output_keys=[]
    ):
        """Load from a JSON manifest."""
        data = load_data_json(json_path, replacements)
        return cls(data, dynamic_items, output_keys)

    @classmethod
    def from_csv(
        cls, csv_path, replacements={}, dynamic_items=[], output_keys=[]
    ):
        """Load from a CSV manifest."""
        data = load_data_csv(csv_path, replacements)
        return cls(data, dynamic_items, output_keys)


class FilteredSortedDynamicItemDataset(DynamicItemDataset):
    """Shares the static data and pipeline of an existing dataset, with a
    possibly reordered/subset view of the ids.
    """

    def __init__(self, from_dataset, data_ids):
        self.data = from_dataset.data
        self.data_ids = list(data_ids)
        self.pipeline = copy.deepcopy(from_dataset.pipeline)

    @classmethod
    def from_json(cls, *args, **kwargs):
        """Construct from a JSON manifest (filtered/sorted view)."""
        raise TypeError("Cannot create FilteredSorted from json directly")

    @classmethod
    def from_csv(cls, *args, **kwargs):
        """Construct from a CSV manifest (filtered/sorted view)."""
        raise TypeError("Cannot create FilteredSorted from csv directly")
