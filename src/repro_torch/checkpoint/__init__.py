"""Checkpoints and the restartable disk-tier factorization (port of
``repro/checkpoint``)."""
from .manager import CheckpointManager
from .restart import (JournaledTileStore, RestartableFactorization,
                      TileJournal)

__all__ = ["CheckpointManager", "JournaledTileStore",
           "RestartableFactorization", "TileJournal"]
