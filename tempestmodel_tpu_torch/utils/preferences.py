"""Key-value preferences file parser.

Counterpart of the JAX package's ``utils/preferences.py`` (a plain copy:
the port imports nothing of that package).  Analog of the reference
``Preferences`` class (``src/base/Preferences.{h,cpp}``): parses
``name = value`` lines (``#`` comments, blank lines ignored) into a
typed-accessor mapping.
The reference keeps this in its base library (unused by the atm layer);
here it serves as a simple loader of key-value run-configuration files.
"""

from __future__ import annotations


class Preferences:
    """Typed key-value preferences loaded from a file or dict."""

    def __init__(self, source=None):
        self._map: dict[str, str] = {}
        if isinstance(source, dict):
            self._map.update({str(k): str(v) for k, v in source.items()})
        elif source is not None:
            self.parse(source)

    def parse(self, filename: str) -> None:
        """Parse ``name = value`` lines (reference ``ParsePreferences``)."""
        with open(filename) as f:
            for lineno, raw in enumerate(f, 1):
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if "=" not in line:
                    raise ValueError(
                        f"{filename}:{lineno}: expected 'name = value', "
                        f"got {raw.rstrip()!r}")
                name, value = line.split("=", 1)
                self._map[name.strip()] = value.strip()

    # --- throwing accessors (reference GetPreferenceAs*) ---
    def get_string(self, name: str) -> str:
        try:
            return self._map[name]
        except KeyError:
            raise KeyError(f"preference {name!r} not found") from None

    def get_string_nocase(self, name: str) -> str:
        return self.get_string(name).lower()

    def get_double(self, name: str) -> float:
        return float(self.get_string(name))

    def get_int(self, name: str) -> int:
        return int(self.get_string(name), 0)

    def get_bool(self, name: str) -> bool:
        v = self.get_string(name).lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"preference {name!r} is not a boolean: {v!r}")

    # --- no-throw accessors (reference *_NoThrow) ---
    def get(self, name: str, default=None, cast=None):
        if name not in self._map:
            return default
        v = self._map[name]
        return cast(v) if cast is not None else v

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __len__(self) -> int:
        return len(self._map)

    def items(self):
        return self._map.items()
