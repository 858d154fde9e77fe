"""Frozen view; the .view module is exempt from RS302 internally."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexView:
    version: int

    @classmethod
    def capture(cls, index, version=0):
        del index
        return cls(version=version)
