"""Debug codecs: SSZ value <-> YAML/JSON-friendly encoding, random object factory."""
