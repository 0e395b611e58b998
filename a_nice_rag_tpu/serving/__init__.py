"""Serving layer: batch scheduling, chat app, feedback.

The reference serves one query at a time from a Streamlit session
(src/app.py). For production serving the framework adds a
micro-batching scheduler that coalesces concurrent queries into one
fused device program launch (a_nice_rag_tpu.serving.scheduler), plus the
chat-app surface (Streamlit when installed, terminal otherwise) and the
thumbs-up/down feedback log.
"""

from a_nice_rag_tpu.serving.scheduler import (  # noqa: F401
    BatchScheduler,
    SchedulerPool,
)
from a_nice_rag_tpu.serving.feedback import FeedbackLog  # noqa: F401
from a_nice_rag_tpu.serving.native_front import (  # noqa: F401
    NativeFrontClient,
    NativeRetrievalFront,
)
