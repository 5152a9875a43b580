from .bst import BinarySearchStore
from .storage import (
    AttributeDict,
    CompressedStorage,
    MeshStorage,
    SkeletonStorage,
    VoxelStorage,
    VoxelStorageDyn,
    VoxelStorageLazyLoading,
)

__all__ = [
    "BinarySearchStore",
    "AttributeDict",
    "CompressedStorage",
    "MeshStorage",
    "SkeletonStorage",
    "VoxelStorage",
    "VoxelStorageDyn",
    "VoxelStorageLazyLoading",
]
