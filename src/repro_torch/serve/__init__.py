"""The port's serving plane for the store: tenant auth, the multi-tenant
gateway, its TCP transport and the framed client.  The LM serving step
of the JAX package's ``serve`` is not part of the port yet."""
from repro_torch.serve.auth import (AuthError,  # noqa: F401
                                    TokenAuthenticator, mint_token)
from repro_torch.serve.storage_service import (GatewayConfig,  # noqa: F401
                                               StorageGateway)
from repro_torch.serve.storage_client import (GatewayClient,  # noqa: F401
                                              GatewayError, RetryLater)
from repro_torch.serve.transport import (GatewayServer,  # noqa: F401
                                         SocketChannel)
