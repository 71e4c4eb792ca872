"""The port's serving package: the LM serving steps, and the store's
serving plane (tenant auth, the multi-tenant gateway, its TCP transport
and the framed client)."""
from repro_torch.serve.servestep import (make_decode_step,  # noqa: F401
                                         make_prefill_step)
from repro_torch.serve.auth import (AuthError,  # noqa: F401
                                    TokenAuthenticator, mint_token)
from repro_torch.serve.storage_service import (GatewayConfig,  # noqa: F401
                                               StorageGateway)
from repro_torch.serve.storage_client import (GatewayClient,  # noqa: F401
                                              GatewayError, RetryLater)
from repro_torch.serve.transport import (GatewayServer,  # noqa: F401
                                         SocketChannel)
