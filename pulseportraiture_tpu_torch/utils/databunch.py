"""DataBunch: attribute-accessible dict used as the universal result record.

Equivalent of the reference's ``DataBunch`` (pplib.py:125-136).
"""


class DataBunch(dict):
    """dict with attribute access: ``db.a`` is ``db['a']``."""

    def __init__(self, **kwds):
        dict.__init__(self, kwds)
        self.__dict__ = self

    def __repr__(self):  # stable ordering for readable printing
        keys = ", ".join(sorted(self.keys()))
        return f"DataBunch({keys})"


__all__ = ["DataBunch"]
