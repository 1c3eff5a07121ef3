"""Catalog: schema objects and the AdaCom segment-access catalog."""
