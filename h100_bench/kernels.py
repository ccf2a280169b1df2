"""Names by which the traced window's device operations are sorted."""


def is_copy(name: str) -> bool:
    """Memory copies and sets: device operations, not kernel launches."""
    return name.startswith("Memcpy") or name.startswith("Memset")
