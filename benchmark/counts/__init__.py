"""Work counts behind the rooflines: what the inputs need, from shapes.

Each function returns (operations, bytes). An operation is one
arithmetic step or comparison on one value (a multiply-add is two); bytes
are each input read once and each output written once, with no padded
slot and no one-hot. The least time of a call is
max(operations / peak rate, bytes / memory bandwidth), from
``benchmark/peaks.json``.
"""
