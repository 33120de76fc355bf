"""A compiled model's nodes as a reader outside the vmapped density reads
them: whole, on a mesh's data axis too (``WholeValues``)."""

from __future__ import annotations

from collections.abc import Mapping

import torch


class WholeValues(Mapping):
    """Every node's value as a reader outside the vmapped density reads it
    (a Gibbs or custom block, a monitor): whole.  A value that this data
    rank holds in part (``cm.local_dims``) is gathered over the data group
    when it is first read, its padded tails dropped (``cm.trim``), so that
    a Gibbs block's ``fn`` reads the array as given, as the unsharded run
    does; one that is neither whole nor a slice
    (``cm.mixed``) is computed again from its parents' whole values, each
    gathered or computed again in turn, their padded tails dropped
    (``cm.trim``: an array the data axis pads, ``cm.pads``, is read as it
    was given), so that it is the unsharded run's value.  These are
    collectives: every data rank runs the same reader on the same stream,
    so all read the same keys in the same order.  Inputs are unstacked,
    every other value chain-stacked.  Without a data axis nothing is
    gathered or computed again (``cm.whole`` returns the value,
    ``cm.mixed`` is empty): a read neither waits for the device nor copies
    from the host, so a captured Gibbs body may read it."""

    def __init__(self, cm, inputs: dict, nodes: dict):
        self._cm, self._inputs, self._nodes = cm, inputs, nodes
        self._whole: dict = {}

    def __getitem__(self, name):
        if name not in self._whole:
            cm = self._cm
            if name in cm.mixed:
                node = cm.model.nodes[name]
                dims = tuple(None if d in self._inputs and d not in self._nodes
                             else 0 for d in node.deps)
                args = [cm.trim(d, self[d], 0 if at is None else 1)
                        for d, at in zip(node.deps, dims)]
                with torch.device(cm.device):
                    value = torch.func.vmap(node.fn, in_dims=dims)(*args)
                value = cm.pad_back(name, value, lead=1)
            elif name in self._nodes:
                value = cm.trim(name, cm.whole(name, self._nodes[name], 1), 1)
            else:
                value = cm.trim(name, cm.whole(name, self._inputs[name]))
            self._whole[name] = value
        return self._whole[name]

    def __iter__(self):
        yield from self._inputs
        yield from (n for n in self._nodes if n not in self._inputs)

    def __len__(self):
        return len(set(self._inputs) | set(self._nodes))
