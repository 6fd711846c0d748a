"""Serving layer of the PyTorch port: the micro-batching render service and
its HTTP job API.

``RenderService`` (``serving.batcher``) queues concurrent jobs, groups them
by everything that sets the render's shapes, and dispatches each group as
ONE ``render_batch`` call on the card; ``serving.service`` exposes it as a
standard-library HTTP JSON job API.
"""

from .batcher import RenderJob, RenderResult, RenderService

__all__ = ["RenderJob", "RenderResult", "RenderService"]
