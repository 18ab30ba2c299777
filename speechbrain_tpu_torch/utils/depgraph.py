"""A dependency graph with topological ordering.

Used by the data pipeline (``utils.data_pipeline``) to evaluate only
the dynamic items needed for the requested output keys, in dependency
order.  A copy of ``speechbrain_tpu/utils/depgraph.py`` (the port
imports nothing of the JAX package).

Example
-------
>>> g = DependencyGraph()
>>> _ = g.add_node("c")
>>> _ = g.add_node("b")
>>> _ = g.add_node("a")
>>> g.add_edge("c", "b")  # c depends on b
>>> g.add_edge("b", "a")  # b depends on a
>>> [n.key for n in g.get_evaluation_order()]
['a', 'b', 'c']
"""

import collections
import uuid

__all__ = ["DependencyGraph", "CircularDependencyError"]


class CircularDependencyError(ValueError):
    """Raised when the graph contains a cycle, so no topological order exists."""


DGNode = collections.namedtuple("DGNode", ["key", "edges", "data"])
# key: hashable identifier; edges: list of keys this node depends on
# data: arbitrary payload attached to the node


class DependencyGraph:
    """Directed graph with cycle detection and topological evaluation order.

    Nodes may be added before or after the edges referencing them; an edge
    to an unknown key implicitly creates that node.  ``add_node`` with no
    key generates a unique one (returned to the caller).
    """

    def __init__(self):
        self.digraph = []  # list of DGNode
        self.key2ind = {}
        self._manually_added_keys = set()

    @staticmethod
    def get_unique_key():
        """Return a new unique node key."""
        return uuid.uuid4()

    def add_node(self, key=None, data=None):
        """Add a node explicitly.

        Returns the key.  Re-adding a key that was only implicitly created
        (by an edge) attaches the data; re-adding an explicitly added key
        raises ``ValueError``.
        """
        if key is None:
            key = self.get_unique_key()
        elif key in self._manually_added_keys:
            raise ValueError(f"Adding duplicate node: {key}")
        else:
            self._manually_added_keys.add(key)
        if key in self.key2ind:
            ind = self.key2ind[key]
            node = self.digraph[ind]
            self.digraph[ind] = DGNode(node.key, node.edges, data)
            return key
        self.key2ind[key] = len(self.digraph)
        self.digraph.append(DGNode(key, [], data))
        return key

    def add_edge(self, from_key, to_key):
        """Declare that ``from_key`` depends on ``to_key``."""
        from_ind = self._get_ind_and_add_if_new(from_key)
        to_ind = self._get_ind_and_add_if_new(to_key)
        edges = self.digraph[from_ind].edges
        if to_ind not in edges:
            edges.append(to_ind)

    def _get_ind_and_add_if_new(self, key):
        if key not in self.key2ind:
            self.key2ind[key] = len(self.digraph)
            self.digraph.append(DGNode(key, [], None))
        return self.key2ind[key]

    def is_valid(self):
        """True iff the graph has no cycles."""
        return not self._find_first_cycle()

    def get_evaluation_order(self, selected_keys=None):
        """Yield nodes in an order where dependencies come first.

        Arguments
        ---------
        selected_keys : iterable, optional
            If given, only these nodes and their transitive dependencies
            are yielded.
        """
        seen_ever = set()

        def toposort(root_ind, visiting):
            node = self.digraph[root_ind]
            if root_ind in visiting:
                raise CircularDependencyError(
                    f"{node.key} is in a dependency cycle"
                )
            if root_ind in seen_ever:
                return
            seen_ever.add(root_ind)
            visiting = visiting | {root_ind}
            for dep_ind in node.edges:
                yield from toposort(dep_ind, visiting)
            yield node

        if selected_keys is None:
            start_inds = range(len(self.digraph))
        else:
            start_inds = [self.key2ind[key] for key in selected_keys]
        for start_ind in start_inds:
            yield from toposort(start_ind, frozenset())

    def _find_first_cycle(self):
        try:
            list(self.get_evaluation_order())
        except CircularDependencyError as e:
            return str(e)
        return ""

    def __contains__(self, key):
        return key in self.key2ind
